"""Paper Fig 8 with the port: NPB IS/CG/MG/FT/LU ratios to ring, classes A
and C (the counterpart of ``benchmarks/fig8_npb.py``)."""
from repro_torch import api

from . import torch_common as common

KERNELS = ("is", "cg", "mg", "ft", "lu")


def run(device=None) -> common.Rows:
    rows = common.Rows("fig8")
    workloads = [(f"{kern}-{klass}", "npb", {"kernel": kern, "klass": klass})
                 for kern in KERNELS for klass in ("A", "C")]
    for key in ("16", "32"):
        exp = api.run_experiment(api.paper_suite(key), workloads=workloads,
                                 cache_dir=common.CACHE_DIR, device=device)
        for wkey, _, _ in workloads:
            ratios = exp.ratios(wkey)
            for name in exp.names:
                rows.add(f"{wkey}/{name}", exp.values[name][wkey],
                         f"ratio={ratios[name]:.3f}")
    return rows
