"""Paper Fig 10 with the port: 256-node simulated Alltoall / b_eff / FFTE /
Graph500-BFS / NPB IS+FT ratios to ring (SimGrid-reduced sizes) — the
counterpart of ``benchmarks/fig10_large_sim.py``."""
from repro_torch import api

from . import torch_common as common

WORKLOADS = (
    [(f"alltoall-{sz_name}", "collective", {"op": "alltoall", "unit_bytes": sz})
     for sz_name, sz in (("64KB", 64 << 10), ("512KB", 512 << 10))]
    + [("beff", "beff", {"n_sizes": 5, "n_random": 2}),
       ("ffte", "ffte", {"array_len": 1 << 21}),
       ("g500-bfs", "graph500", {"scale": 12})]
    + [(f"npb-{kern}-{klass}", "npb", {"kernel": kern, "klass": klass})
       for kern, klass in (("is", "S"), ("is", "A"), ("ft", "A"))]
)


def run(device=None) -> common.Rows:
    rows = common.Rows("fig10")
    exp = api.run_experiment(api.paper_suite("256"), workloads=WORKLOADS,
                             cache_dir=common.CACHE_DIR, device=device)
    ring = next(n for n in exp.names if "Ring" in n)
    for wkey, _, _ in WORKLOADS:
        if wkey == "beff":  # bandwidth: higher is better, ratio inverts
            vals = {n: exp.values[n][wkey] for n in exp.names}
            for n in exp.names:
                rows.add(f"beff/{n}", 1.0 / vals[n],
                         f"ratio={vals[n]/vals[ring]:.2f}")
            continue
        ratios = exp.ratios(wkey)
        for n in exp.names:
            rows.add(f"{wkey}/{n}", exp.values[n][wkey], f"ratio={ratios[n]:.2f}")
    return rows
