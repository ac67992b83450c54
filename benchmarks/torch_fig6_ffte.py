"""Paper Fig 6 with the port: 1-D parallel FFTE ratios to ring at 2^21 and
2^27 points (the counterpart of ``benchmarks/fig6_ffte.py``)."""
from repro_torch import api

from . import torch_common as common

LENS = {"32MB": 1 << 21, "2GB": 1 << 27}


def run(device=None) -> common.Rows:
    rows = common.Rows("fig6")
    workloads = [(ln, "ffte", {"array_len": n_pts}) for ln, n_pts in LENS.items()]
    for key in ("16", "32"):
        exp = api.run_experiment(api.paper_suite(key), workloads=workloads,
                                 cache_dir=common.CACHE_DIR, device=device)
        for ln in LENS:
            ratios = exp.ratios(ln)
            for name in exp.names:
                rows.add(f"{ln}/{name}", exp.values[name][ln],
                         f"ratio={ratios[name]:.3f}")
    return rows
