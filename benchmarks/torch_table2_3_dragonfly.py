"""Paper TABLE 2+3 with the port: high-radix optimal vs Dragonfly at
(20,4)/(30,5)/(36,5), graph properties + b_eff / Graph500 / Alltoall
performance ratios (optimal over dragonfly) — the counterpart of
``benchmarks/table2_3_dragonfly.py``."""
from repro_torch import api

from . import torch_common as common

PAPER_T2 = {  # name -> (D_opt, MPL_opt, D_df, MPL_df)
    "(20,4)": (3, 1.95, 3, 2.26),
    "(30,5)": (3, 1.97, 3, 2.38),
    "(36,5)": (3, 2.14, 3, 2.34),
}

WORKLOADS = (
    [("stats", {"bw_restarts": 16}),
     ("beff", {"n_sizes": 9, "n_random": 4})]
    + [(f"g500-{op}", "graph500", {"scale": 20, "op": op})
       for op in ("bfs", "sssp")]
    + [(f"alltoall-{sz_name}", "collective",
        {"op": "alltoall", "unit_bytes": sz})
       for sz_name, sz in (("1MB", 1 << 20), ("32MB", 32 << 20))]
)


def run(device=None) -> common.Rows:
    rows = common.Rows("table2_3")
    exp = api.run_experiment(api.paper_suite("dragonfly"), workloads=WORKLOADS,
                             cache_dir=common.CACHE_DIR, device=device)
    for key in PAPER_T2:
        vo, vd = exp.values[f"{key}-Optimal"], exp.values[f"{key}-Dragonfly"]
        so, sd = vo["stats"], vd["stats"]
        dt = exp.seconds[f"{key}-Optimal"]["stats"] + \
            exp.seconds[f"{key}-Dragonfly"]["stats"]
        pd = PAPER_T2[key]
        rows.add(f"props/{key}", dt,
                 f"opt D={so.diameter:.0f} MPL={so.mpl:.3f} BW={so.bw} | "
                 f"dfly D={sd.diameter:.0f} MPL={sd.mpl:.3f} BW={sd.bw} | "
                 f"paper opt(D={pd[0]},MPL={pd[1]}) dfly(D={pd[2]},MPL={pd[3]})")
        rows.add(f"beff/{key}", 0.0, f"opt/dfly={vo['beff'] / vd['beff']:.3f}")
        for op_name in ("bfs", "sssp"):
            r = vd[f"g500-{op_name}"] / vo[f"g500-{op_name}"]
            rows.add(f"g500-{op_name}/{key}", 0.0, f"opt/dfly={r:.3f}")
        for sz_name in ("1MB", "32MB"):
            r = vd[f"alltoall-{sz_name}"] / vo[f"alltoall-{sz_name}"]
            rows.add(f"alltoall-{sz_name}/{key}", 0.0, f"opt/dfly={r:.3f}")
    return rows
