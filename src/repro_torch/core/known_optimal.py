"""Pinned best-known circulant offset sets, the warm starts of the large-N
tier, loaded from the port's own table ``data/circulant_offsets.json``.

``KNOWN_CIRCULANT_OFFSETS`` maps ``(n, k)`` to the full offset tuple
(ring offset 1 included), as ``repro.core.known_optimal`` does.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["KNOWN_CIRCULANT_OFFSETS"]

_TABLE = Path(__file__).resolve().parent.parent / "data" / "circulant_offsets.json"


def _load() -> dict[tuple[int, int], tuple[int, ...]]:
    with open(_TABLE) as f:
        entries = json.load(f)["entries"]
    return {(int(e["n"]), int(e["k"])): tuple(int(o) for o in e["offsets"])
            for e in entries}


KNOWN_CIRCULANT_OFFSETS = _load()
