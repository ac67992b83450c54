"""Quickstart on the PyTorch port: discover an optimal topology (the
paper's core algorithm), compare it against mainstream topologies on the
paper's benchmarks, and lay out a (4, 4) device mesh on it.

The counterpart of ``examples/quickstart.py`` over ``repro_torch`` only; it
prints the same lines.  Every graph's MPL is ``metrics.mpl`` through
``bfs_sweep_kernel`` on the card (the default) or its plain PyTorch
version with ``--device cpu``; the search and the layout annealer run on
the host.

    python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch import api
from repro_torch.core import graphs, layout, metrics, netsim
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a CUDA device) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)  # raises before any output without the device

    # 1. Discover a minimal-MPL (16,4) regular graph (paper Algorithm 1) through
    #    the declarative search API: the spec names the tier, budget and seed.
    res = api.search(api.SearchSpec.make(16, 4, strategy="sa", budget=4000, seed=0),
                     device=dev)
    opt = res.graph
    print(f"found {opt.name}: MPL={res.mpl:.4f} (lower bound {res.mpl_lb:.4f}), "
          f"D={res.diameter:.0f}, {res.iterations} SA iterations")

    # 2. Compare against ring / torus on the paper's benchmarks.
    print(f"\n{'topology':18s} {'MPL':>6s} {'BW':>3s} {'alltoall':>9s} {'b_eff':>9s} "
          f"{'G500-BFS':>9s}")
    ring = graphs.ring(16)
    t_ring = {}
    for g in (ring, graphs.torus([4, 4]), graphs.wagner(16), opt):
        cl = netsim.TAISHAN(g)
        a2a = netsim.collective_bench(cl, "alltoall", 1 << 20)
        beff = netsim.effective_bandwidth(cl, n_sizes=7, n_random=3)
        g500 = netsim.graph500(cl, scale=20)
        if g is ring:
            t_ring = {"a2a": a2a, "beff": beff, "g500": g500}
        print(f"{g.name:18s} {metrics.mpl(g, device=dev):6.3f} {metrics.bisection_width(g):3d} "
              f"{t_ring['a2a']/a2a:8.2f}x {beff/t_ring['beff']:8.2f}x "
              f"{t_ring['g500']/g500:8.2f}x")

    # 3. Map a (4, 4) = (data, model) mesh onto the optimal graph (QAP layout).
    traffic = layout.mesh_traffic((4, 4), (1e6, 16e6))  # model axis 16x hotter
    lay = layout.optimize_layout(opt, traffic, seed=0, n_iter=8000, device=dev)
    print(f"\nmesh layout on {opt.name}: traffic-weighted hops "
          f"{lay.identity_cost:.3g} -> {lay.cost:.3g} ({lay.improvement:.1%} better)")
    print("device order:", lay.perm.tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
