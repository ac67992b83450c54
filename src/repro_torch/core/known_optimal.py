"""Pinned best-known graphs, loaded from the port's certified table
``data/certified.json`` (see ``core.certify``), as ``repro.core.known_optimal``
loads them from the reference's.

``KNOWN_EDGE_LISTS``
    ``(n, k) -> edge tuple`` for the frozen optimal graphs of the deep SA
    search; ``OPTIMAL_16_4`` / ``OPTIMAL_32_3`` / ``OPTIMAL_32_4`` are
    aliases.

``KNOWN_CIRCULANT_OFFSETS``
    ``(n, k) -> offset tuple`` (ring offset 1 included) for the best
    circulant offset sets, the warm starts of the large-N tier.
"""
from __future__ import annotations

from . import certify

__all__ = ["KNOWN_EDGE_LISTS", "KNOWN_CIRCULANT_OFFSETS",
           "OPTIMAL_16_4", "OPTIMAL_32_4", "OPTIMAL_32_3"]


def _load() -> tuple[dict, dict]:
    edge_lists: dict[tuple[int, int], tuple[tuple[int, int], ...]] = {}
    offsets: dict[tuple[int, int], tuple[int, ...]] = {}
    for e in certify.table_entries():
        key = (int(e["n"]), int(e["k"]))
        if e["family"] == "optimal" and e.get("edges") is not None:
            edge_lists[key] = tuple(tuple(edge) for edge in e["edges"])
        elif e["family"] == "circulant" and e.get("offsets") is not None:
            offsets[key] = tuple(int(o) for o in e["offsets"])
    return edge_lists, offsets


KNOWN_EDGE_LISTS, KNOWN_CIRCULANT_OFFSETS = _load()

# aliases for the three pinned optimal instances
OPTIMAL_16_4 = KNOWN_EDGE_LISTS[(16, 4)]
OPTIMAL_32_4 = KNOWN_EDGE_LISTS[(32, 4)]
OPTIMAL_32_3 = KNOWN_EDGE_LISTS[(32, 3)]
