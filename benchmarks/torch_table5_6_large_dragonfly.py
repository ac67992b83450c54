"""Paper TABLE 5+6 with the port: (252/264,11) optimal vs Dragonfly,
properties + simulated b_eff / Graph500 / Alltoall ratios — the counterpart
of ``benchmarks/table5_6_large_dragonfly.py``."""
from repro_torch import api

from . import torch_common as common

WORKLOADS = (
    [("stats", {"bw_restarts": 4}),
     ("beff", {"n_sizes": 5, "n_random": 2}),
     ("g500-bfs", "graph500", {"scale": 12, "op": "bfs"})]
    + [(f"alltoall-{sz_name}", "collective",
        {"op": "alltoall", "unit_bytes": sz})
       for sz_name, sz in (("64KB", 64 << 10), ("512KB", 512 << 10))]
)


def run(device=None) -> common.Rows:
    rows = common.Rows("table5_6")
    exp = api.run_experiment(api.paper_suite("large-dragonfly"),
                             workloads=WORKLOADS, cache_dir=common.CACHE_DIR,
                             device=device)
    for key in ("(252,11)", "(264,11)"):
        vo, vd = exp.values[f"{key}-Optimal"], exp.values[f"{key}-Dragonfly"]
        so, sd = vo["stats"], vd["stats"]
        dt = exp.seconds[f"{key}-Optimal"]["stats"] + \
            exp.seconds[f"{key}-Dragonfly"]["stats"]
        rows.add(f"props/{key}", dt,
                 f"opt D={so.diameter:.0f} MPL={so.mpl:.3f} BW={so.bw} | "
                 f"dfly D={sd.diameter:.0f} MPL={sd.mpl:.3f} BW={sd.bw}")
        rows.add(f"beff/{key}", 0.0, f"opt/dfly={vo['beff'] / vd['beff']:.3f}")
        rows.add(f"g500-bfs/{key}", 0.0,
                 f"opt/dfly={vd['g500-bfs'] / vo['g500-bfs']:.3f}")
        for sz_name in ("64KB", "512KB"):
            r = vd[f"alltoall-{sz_name}"] / vo[f"alltoall-{sz_name}"]
            rows.add(f"alltoall-{sz_name}/{key}", 0.0, f"opt/dfly={r:.3f}")
    return rows
