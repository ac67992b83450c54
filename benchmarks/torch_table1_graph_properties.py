"""Paper TABLE 1 with the port: D / MPL / BW of the benchmarked low-radix
topologies (the counterpart of ``benchmarks/table1_graph_properties.py``,
the same suites, workload, rows and published targets), priced through
``repro_torch.api`` on ``device``."""
from repro_torch import api

from . import torch_common as common

PAPER = {  # name -> (D, MPL, BW)
    "(16,4)-Optimal": (3, 1.75, 12), "(16,4)-Torus": (4, 2.13, 8),
    "(16,3)-Optimal": (3, 2.20, 6), "(16,3)-Bidiakis": (5, 2.53, 4),
    "(16,3)-Wagner": (4, 2.60, 4), "(16,2)-Ring": (8, 4.27, 2),
    "(32,4)-Optimal": (3, 2.35, 16), "(32,4)-Chvatal": (4, 2.55, 8),
    "(32,4)-Torus": (6, 3.10, 8), "(32,3)-Optimal": (4, 2.94, 10),
    "(32,3)-Bidiakis": (9, 4.06, 4), "(32,3)-Wagner": (8, 4.61, 4),
    "(32,2)-Ring": (16, 8.26, 2),
}


def run(device=None) -> common.Rows:
    rows = common.Rows("table1")
    exp = api.run_experiment(
        {**api.paper_suite("16"), **api.paper_suite("32")},
        workloads=[("stats", {"bw_restarts": 24})],
        cache_dir=common.CACHE_DIR, device=device)
    for name in exp.names:
        s = exp.values[name]["stats"]
        pd, pm, pb = PAPER[name]
        ok = (s.diameter == pd) and (round(s.mpl, 2) == round(pm, 2)) and (s.bw == pb)
        rows.add(name, exp.seconds[name]["stats"],
                 f"D={s.diameter:.0f}/{pd} MPL={s.mpl:.4f}/{pm} BW={s.bw}/{pb} "
                 f"match={'Y' if ok else 'n'} gapMPL={s.mpl - s.mpl_lb:+.3f}")
    return rows
