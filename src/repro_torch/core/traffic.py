"""Synthetic traffic patterns for routing-tier experiments (the
counterpart of ``repro.core.traffic``, a numpy copy held equal by the tests).

The paper benchmarks applications (§4.2); the adaptive-routing tier also
needs the classic *synthetic* sweeps from the interconnection-network
literature (uniform random, transpose, shift, hotspot) to expose the
congestion behaviours application kernels average away.  Each pattern is a
registered generator ``f(n, rng, **kw) -> list[(src, dst)]`` of one flow
per source node (self-pairs dropped), deterministic per seed.

``repro_torch.core.netsim.traffic_time`` costs these under either routing tier.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np

__all__ = ["TRAFFIC_PATTERNS", "register_traffic", "traffic_pattern",
           "traffic_patterns"]

Flows = list[tuple[int, int]]

TRAFFIC_PATTERNS: dict[str, Callable[..., Flows]] = {}


def register_traffic(name: str):
    """Register a traffic generator under ``name`` (decorator)."""

    def deco(fn: Callable[..., Flows]) -> Callable[..., Flows]:
        if name in TRAFFIC_PATTERNS:
            raise ValueError(f"traffic pattern {name!r} already registered")
        TRAFFIC_PATTERNS[name] = fn
        return fn

    return deco


def traffic_patterns() -> tuple[str, ...]:
    """Registered pattern names, in registration order."""
    return tuple(TRAFFIC_PATTERNS)


def traffic_pattern(name: str, n: int, seed: int = 0, **kw) -> Flows:
    """Generate pattern ``name`` on ``n`` nodes, deterministic per ``seed``."""
    try:
        fn = TRAFFIC_PATTERNS[name]
    except KeyError:
        raise ValueError(
            f"unknown traffic pattern {name!r}; known: {sorted(TRAFFIC_PATTERNS)}"
        ) from None
    if n < 2:
        return []
    return fn(n, np.random.default_rng(seed), **kw)


@register_traffic("uniform")
def _uniform(n: int, rng: np.random.Generator) -> Flows:
    """Each node sends to an independently uniform other node."""
    dst = rng.integers(0, n - 1, size=n)
    dst += dst >= np.arange(n)  # skip self without biasing the draw
    return [(i, int(d)) for i, d in enumerate(dst)]


@register_traffic("random-perm")
def _random_perm(n: int, rng: np.random.Generator) -> Flows:
    """A random permutation; fixed points are dropped."""
    perm = rng.permutation(n)
    return [(i, int(d)) for i, d in enumerate(perm) if i != d]


@register_traffic("transpose")
def _transpose(n: int, rng: np.random.Generator) -> Flows:
    """Matrix-transpose permutation: (r, c) -> (c, r) on a √n×√n grid when
    n is a perfect square, bit-reversal when n is a power of two."""
    s = math.isqrt(n)
    if s * s == n:
        return [(r * s + c, c * s + r) for r in range(s) for c in range(s)
                if r != c]
    if n & (n - 1) == 0:
        bits = n.bit_length() - 1
        rev = [int(format(i, f"0{bits}b")[::-1], 2) for i in range(n)]
        return [(i, rev[i]) for i in range(n) if i != rev[i]]
    raise ValueError(
        f"transpose pattern needs a square or power-of-two node count, got {n}")


@register_traffic("shift")
def _shift(n: int, rng: np.random.Generator, stride: int | None = None) -> Flows:
    """Cyclic shift i -> (i + stride) mod n; default stride n//2 (the
    worst case for mesh-like topologies)."""
    s = (n // 2) if stride is None else (stride % n)
    if s == 0:
        return []
    return [(i, (i + s) % n) for i in range(n)]


@register_traffic("hotspot")
def _hotspot(n: int, rng: np.random.Generator, hot: int = 2,
             frac: float = 0.5) -> Flows:
    """``frac`` of sources target one of ``hot`` random hot nodes (incast),
    the rest send uniformly — the pattern that collapses static routing."""
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"frac={frac} must be in [0, 1]")
    hot = max(1, min(int(hot), n))
    hot_nodes = rng.choice(n, size=hot, replace=False)
    dst = rng.integers(0, n - 1, size=n)
    dst += dst >= np.arange(n)
    to_hot = rng.random(n) < frac
    dst[to_hot] = hot_nodes[rng.integers(0, hot, size=int(to_hot.sum()))]
    return [(i, int(d)) for i, d in enumerate(dst) if i != d]
