"""Paper TABLE 4 with the port: 256-node suboptimal vs torus/Wagner/Bidiakis/
ring, D / MPL / BW and the gap to the Cerf lower bounds — the counterpart of
``benchmarks/table4_large_scale.py``.  The four suboptimal graphs are
searched on ``device`` (``large_search`` and ``symmetric_sa_search`` through
both BFS kernels at n = 256)."""
from repro_torch import api

from . import torch_common as common

PAPER = {
    "(256,8)-Suboptimal": (3 + 1, 2.72 + 0.03, 298), "(256,8)-Torus": (8, 4.02, 128),
    "(256,6)-Suboptimal": (4 + 0, 3.11 + 0.06, 192), "(256,6)-Torus": (10, 5.02, 64),
    "(256,4)-Suboptimal": (5 + 1, 4.09 + 0.05, 92), "(256,4)-Torus": (16, 8.03, 32),
    "(256,3)-Suboptimal": (7 + 1, 5.59 + 0.08, 46), "(256,3)-Bidiakis": (65, 25.09, 4),
    "(256,3)-Wagner": (64, 32.62, 4), "(256,2)-Ring": (128, 64.25, 2),
}


def run(device=None) -> common.Rows:
    rows = common.Rows("table4")
    exp = api.run_experiment(api.paper_suite("256"),
                             workloads=[("stats", {"bw_restarts": 8})],
                             cache_dir=common.CACHE_DIR, device=device)
    for name in exp.names:
        s = exp.values[name]["stats"]
        pd, pm, pb = PAPER[name]
        rows.add(name, exp.seconds[name]["stats"],
                 f"D={s.diameter:.0f} (paper {pd}) MPL={s.mpl:.4f} (paper {pm:.2f}) "
                 f"BW={s.bw} (paper {pb}) | gapD={s.diameter - s.d_lb:+.0f} "
                 f"gapMPL={(s.mpl / s.mpl_lb - 1) * 100:+.1f}%")
    return rows
