"""Paper Fig 3 with the port: mean ping-pong latency performance ratios to
ring (the counterpart of ``benchmarks/fig3_pingpong_ratios.py``; each MPL
through ``metrics.mpl`` on ``device``)."""
from repro_torch import api
from repro_torch.core import metrics

from . import torch_common as common


def run(device=None) -> common.Rows:
    rows = common.Rows("fig3")
    for key in ("16", "32"):
        exp = api.run_experiment(api.paper_suite(key),
                                 workloads=["pingpong_mean"],
                                 cache_dir=common.CACHE_DIR, device=device)
        ratios = exp.ratios("pingpong_mean")
        for name in exp.names:
            rows.add(name, exp.values[name]["pingpong_mean"],
                     f"ratio={ratios[name]:.3f} "
                     f"MPL={metrics.mpl(exp.graphs[name], device=device):.3f}")
    return rows
