#!/usr/bin/env bash
# Serving on one card, two trees in turns: chip_smoke's phase_serve of another
# checkout (PARENT_DIR) and of this one, in the order parent, change, change,
# parent, parent, change.  Card only; run from the root of this checkout:
#
#   git archive <commit> | tar -x -C build/parent
#   bash benchmarks/torch_serve_ab.sh build/parent [ARCH]
#
# ARCH (default zamba2-2.7b) is served at full width and depth, as phase 13
# serves it; a parent whose phase_serve takes no architecture serves its own
# (zamba2-2.7b).  The kernels are built once here and their build directory
# copied to PARENT_DIR (builds are keyed by the sources' hashes, so a parent
# with other sources builds its own).  Prints each run's "served" line (TTFT,
# decode ms/token, tok/s, peak memory, launches) and its first tokens.
set -euo pipefail
parent=$1
arch=${2:-zamba2-2.7b}
python3 -c "import sys; sys.path.insert(0, 'src'); from repro_torch.kernels import _build; _build.library()"
mkdir -p "$parent/src/repro_torch/kernels/_build"
cp src/repro_torch/kernels/_build/* "$parent/src/repro_torch/kernels/_build/"
serve='import inspect, sys
sys.path.insert(0, "src")
import chip_smoke as c
takes_arch = "arch" in inspect.signature(c.phase_serve).parameters
c.phase_serve(*((sys.argv[1], 0) if takes_arch else ()))'
for side in parent change change parent parent change; do
  if [ "$side" = parent ]; then dir=$parent; else dir=.; fi
  (cd "$dir" && python3 -c "$serve" "$arch" 2>&1 | grep -E "served|first tokens|Error" | sed "s/^/$side: /")
done
