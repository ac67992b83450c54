"""Reproduce the paper's headline sweep at any size on the PyTorch port:
search optimal graphs at several degrees, compare D/MPL/BW + predicted
application performance against torus/ring, and report the
MPL->performance correlation (paper Figs 3-10).

The counterpart of ``examples/topology_sweep.py`` over ``repro_torch``
only; it prints the same lines.  The whole sweep is one
``repro_torch.api.run_experiment(..., device=)``: the searched entries run
through ``api.search`` (at the default 64 nodes the SA tier on the host,
through the C fast path; at 256 nodes ``large_search``, priced by the BFS
kernels on the card), ``stats`` prices through ``bfs_sweep_kernel`` on the
card, and the application workloads run on the host.  ``--device cpu`` runs
the kernels' plain PyTorch versions.

    python examples/torch_topology_sweep.py --nodes 64 [--device cpu]
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np

from repro_torch import api
from repro_torch.device import resolve_device

WORKLOADS = [
    ("stats", {"bw_restarts": 8}),
    ("a2a", "alltoall", {"unit_bytes": 1 << 20}),
    ("beff", "beff", {"n_sizes": 5, "n_random": 2}),
    ("ffte", "ffte", {"array_len": 1 << 24}),
    ("is", "npb", {"kernel": "is", "klass": "A"}),
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=64)
    p.add_argument("--budget", type=int, default=2000)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a CUDA device) or cpu")
    args = p.parse_args(argv)
    n = args.nodes
    dev = resolve_device(args.device)

    topos = {f"({n},2)-Ring": api.TopologySpec.make("ring", n=n)}
    if n % 2 == 0:
        topos[f"({n},3)-Wagner"] = api.TopologySpec.make("wagner", n=n)
    # square-ish torus
    a = int(math.sqrt(n))
    while n % a:
        a -= 1
    topos[f"({n},4)-Torus{a}x{n//a}"] = api.TopologySpec.make("torus", dims=[a, n // a])
    for k in (3, 4):
        topos[f"({n},{k})-Optimal"] = api.TopologySpec.make(
            "optimal", n=n, k=k, budget=args.budget, seed=0)

    exp = api.run_experiment(topos, workloads=WORKLOADS, device=dev)

    print(f"{'topology':>22s} {'D':>3s} {'MPL':>7s} {'BW':>4s} | "
          f"{'alltoall':>8s} {'b_eff':>7s} {'FFTE':>7s} {'IS':>7s}")
    ring_name = next(name for name in exp.names if "Ring" in name)
    ring_v = exp.values[ring_name]
    rows = []
    for name in exp.names:
        v = exp.values[name]
        s = v["stats"]
        # beff is a bandwidth (higher = better): ratio inverts vs the times
        speedups = {"a2a": ring_v["a2a"] / v["a2a"],
                    "beff": v["beff"] / ring_v["beff"],
                    "ffte": ring_v["ffte"] / v["ffte"],
                    "is": ring_v["is"] / v["is"]}
        rows.append((s.mpl, speedups["a2a"]))
        print(f"{exp.graphs[name].name:>22s} {s.diameter:3.0f} {s.mpl:7.3f} "
              f"{s.bw:4d} | "
              + " ".join(f"{speedups[k]:7.2f}x" for k in ("a2a", "beff", "ffte", "is")))
    mpls, perf = zip(*rows)
    rho = np.corrcoef(1.0 / np.asarray(mpls), perf)[0, 1]
    print(f"\nPearson correlation (1/MPL vs alltoall speed): {rho:.3f} "
          f"(paper: strong inverse MPL dependence)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
