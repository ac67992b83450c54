"""Paper Fig 7 with the port: Graph500 BFS/SSSP ratios to ring (scale 27;
the counterpart of ``benchmarks/fig7_graph500.py``)."""
from repro_torch import api

from . import torch_common as common


def run(device=None) -> common.Rows:
    rows = common.Rows("fig7")
    workloads = [(op, "graph500", {"scale": 27, "op": op})
                 for op in ("bfs", "sssp")]
    for key in ("16", "32"):
        exp = api.run_experiment(api.paper_suite(key), workloads=workloads,
                                 cache_dir=common.CACHE_DIR, device=device)
        for op, _, _ in workloads:
            ratios = exp.ratios(op)
            for name in exp.names:
                rows.add(f"{op}/{name}", exp.values[name][op],
                         f"ratio={ratios[name]:.3f}")
    return rows
