"""Paper Fig 5 with the port: effective bandwidth (b_eff) ratios to ring
(the counterpart of ``benchmarks/fig5_beff.py``)."""
from repro_torch import api

from . import torch_common as common


def run(device=None) -> common.Rows:
    rows = common.Rows("fig5")
    for key in ("16", "32"):
        exp = api.run_experiment(api.paper_suite(key), workloads=["beff"],
                                 cache_dir=common.CACHE_DIR, device=device)
        vals = {name: exp.values[name]["beff"] for name in exp.names}
        ring = next(k for k in vals if "Ring" in k)
        for name in exp.names:
            rows.add(name, 1.0 / vals[name],
                     f"beff={vals[name]/1e6:.1f}MB/s ratio={vals[name]/vals[ring]:.3f}")
    return rows
