#!/usr/bin/env python3
"""Time the replica polish of two checkouts of the port in turns on one GPU:
A, B, B, A, each turn in a process of its own started in that checkout.

Run from the root of a checkout, with the other unpacked beside it in a
git-ignored directory (for example ``git archive <parent> | tar -x -C
build/parent``):

    python3 benchmarks/torch_polish_turns.py build/parent .

Each turn builds or reuses that checkout's kernels and runs
``large_search(8192, 8, replicas=8, proposal_batch=4, polish_iters=8)`` with
``delta=False`` and ``delta=True`` on the card, after a 2-iteration warm-up,
and prints the host time of each (ending in a device synchronise) and the
MPL found, which must agree.  Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import os
import subprocess
import sys

TURN = """
import os, sys, time
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "src")]
import torch
from repro_torch.kernels import _build
_build.library()
from repro_torch.core.search import large_search
kw = dict(seed=0, fold=4, replicas=8, proposal_batch=4, device="cuda")
large_search(8192, 8, polish_iters=2, delta=False, **kw)
for delta in (False, True):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = large_search(8192, 8, polish_iters=8, delta=delta, **kw)
    torch.cuda.synchronize()
    print(f"delta={delta} {time.perf_counter() - t0:.3f} s mpl={float(r.mpl)!r}", flush=True)
"""


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    outs = {}
    for tree in (argv[0], argv[1], argv[1], argv[0]):
        proc = subprocess.run([sys.executable, "-c", TURN], cwd=os.path.abspath(tree),
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        for line in proc.stdout.splitlines():
            print(f"{tree}: {line}", flush=True)
        outs.setdefault(tree, set()).update(
            line.split("mpl=")[1] for line in proc.stdout.splitlines() if "mpl=" in line)
    if len(set.union(*outs.values())) != 1:
        print(f"the checkouts found different MPLs: {outs}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
