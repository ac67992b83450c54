#!/usr/bin/env python3
"""The paper's tables and figures with the PyTorch port (the counterpart of
``benchmarks/run.py``): one ``benchmarks/torch_<name>.py`` module per paper
table or figure, each over ``repro_torch.api`` on ``--device``.  Prints
``name,us_per_call,derived`` CSV rows and saves JSON under
``results/torch_benchmarks/``.

    python3 benchmarks/torch_run.py [--only table1,fig4,...] [--device cpu]
    python3 benchmarks/torch_run.py --smoke     # fig4 and fig_routing

``--device`` defaults to the CUDA device (the searched builds and ``stats``
price there; the netsim models run on the host); without one the run stops
before any module runs.  ``--parallel`` (or ``REPRO_PARALLEL=1``) forks
``run_experiment``'s grid over a process pool, which cannot use a CUDA
device its parent initialised: it is refused on a CUDA device before any
build.  The reference's ``roofline`` and ``topology_term`` read the dry
run's ``results/dryrun.json`` and are not ported yet; ``bench_search``'s
polish rows are ``benchmarks/torch_bench_search.py``.
"""
import argparse
import os
import sys
import time

if __package__ in (None, ""):  # executed as a script: bootstrap the paths
    _REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, _REPO)
    sys.path.insert(0, os.path.join(_REPO, "src"))

from benchmarks import (torch_fig2_pingpong, torch_fig3_pingpong_ratios,  # noqa: E402
                        torch_fig4_collectives, torch_fig5_beff, torch_fig6_ffte,
                        torch_fig7_graph500, torch_fig8_npb, torch_fig10_large_sim,
                        torch_fig_routing, torch_table1_graph_properties,
                        torch_table2_3_dragonfly, torch_table4_large_scale,
                        torch_table5_6_large_dragonfly)

MODULES = {
    "table1": torch_table1_graph_properties,
    "fig2": torch_fig2_pingpong,
    "fig3": torch_fig3_pingpong_ratios,
    "fig4": torch_fig4_collectives,
    "fig5": torch_fig5_beff,
    "fig6": torch_fig6_ffte,
    "fig7": torch_fig7_graph500,
    "fig8": torch_fig8_npb,
    "table2_3": torch_table2_3_dragonfly,
    "table4": torch_table4_large_scale,
    "table5_6": torch_table5_6_large_dragonfly,
    "fig10": torch_fig10_large_sim,
    "fig_routing": torch_fig_routing,
}

# the reference's smoke subset without bench_search
SMOKE_KEYS = ["fig4", "fig_routing"]


def main(argv=None) -> dict:
    """Run the modules; returns each module's ``Rows`` and seconds by key."""
    from repro_torch.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", default=None, help="comma-separated module keys")
    p.add_argument("--smoke", action="store_true", help="the fast subset: fig4, fig_routing")
    p.add_argument("--parallel", action="store_true",
                   help="fan run_experiment grids out over a process pool "
                        "(sets REPRO_PARALLEL=1; CPU only)")
    p.add_argument("--device", default=None,
                   help="where to price: the CUDA device unless 'cpu'")
    args = p.parse_args(argv)
    keys = args.only.split(",") if args.only else SMOKE_KEYS if args.smoke else list(MODULES)
    unknown = [k for k in keys if k not in MODULES]
    if unknown:
        p.error(f"unknown module(s) {unknown}; choose from {sorted(MODULES)}")
    dev = resolve_device(args.device)
    if dev.type == "cuda" and (args.parallel or os.environ.get("REPRO_PARALLEL", "") == "1"):
        p.error("--parallel (or REPRO_PARALLEL=1) forks worker processes, which cannot "
                "use a CUDA device their parent initialised: run serially on the card "
                "or pass --device cpu")
    if args.parallel:
        os.environ["REPRO_PARALLEL"] = "1"
    print("name,us_per_call,derived")
    out = {}
    for k in keys:
        t0 = time.perf_counter()
        rows = MODULES[k].run(device=dev)
        rows.emit()
        rows.save()
        secs = time.perf_counter() - t0
        out[k] = (rows, secs)
        print(f"# {k} done in {secs:.1f}s", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
