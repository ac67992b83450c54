"""Reporting rows for the port's table and figure modules
(``benchmarks/torch_*.py``):
the counterpart of ``benchmarks/common.py``'s ``Rows``, without its
deprecated suite shims (the suites come from ``repro_torch.api.paper_suite``).

The port's searched graphs are cached under ``results/torch_benchcache/``
and its artifacts written under ``results/torch_benchmarks/``, so a port
run never touches the reference's ``results/benchcache/`` or
``results/benchmarks/BENCH_*.json``.
"""
from __future__ import annotations

import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "src"))

#: spec-keyed graph cache of the searched suite entries (``repro_torch.api``)
CACHE_DIR = os.path.join(_REPO, "results", "torch_benchcache")
#: where ``Rows.save`` writes
OUT_DIR = os.path.join(_REPO, "results", "torch_benchmarks")


class Rows:
    """Collects (name, us_per_call, derived) CSV rows + saves JSON.

    Modules with a canonical machine-readable artifact pass ``artifact``
    (e.g. ``Rows("fig4", artifact="fig4")``): they append their result dicts
    to ``.results`` (and top-level fields to ``.meta``) and ``save()`` writes
    ``BENCH_<artifact>.json``.  Artifact-less modules write the
    ``<bench>.json`` rows dump."""

    def __init__(self, bench: str, artifact: str | None = None):
        self.bench = bench
        self.artifact = artifact
        self.rows: list[tuple[str, float, str]] = []
        self.results: list[dict] = []
        self.meta: dict = {}

    def add(self, name: str, seconds: float, derived: str) -> None:
        self.rows.append((f"{self.bench}/{name}", seconds * 1e6, derived))

    def emit(self) -> None:
        for name, us, derived in self.rows:
            print(f"{name},{us:.3f},{derived}")

    def save(self) -> None:
        os.makedirs(OUT_DIR, exist_ok=True)
        if self.artifact is not None:
            path = os.path.join(OUT_DIR, f"BENCH_{self.artifact}.json")
            payload = {**self.meta, "results": self.results}
        else:
            path = os.path.join(OUT_DIR, self.bench + ".json")
            payload = [{"name": n, "us": u, "derived": d} for n, u, d in self.rows]
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
