"""The port's small-N search tiers (``repro_torch.core.search``'s
``sa_search``, ``exhaustive_search`` and ``sa_objective_search``) and the
dense incremental evaluator (``repro_torch.core.metrics.IncrementalAPSP``)
against the JAX package's, on the CPU.

Both packages draw from the same numpy Generators (``default_rng([seed, r])``
per replica, each chunk's randomness drawn up front) and accept on exact
integer hop totals, so every field of the result must be equal.  Both
packages run their C ``sa_chunk`` (the port's host C fast path, a copy of
the reference's source; ``tests/test_torch_fastpath.py`` holds it to the
python mirror).  The evaluator, whose 2+2 swaps go through the C
``eval_swap``, is compared with the reference's numpy path (``use_c=False``),
token by token and counter by counter.
"""
import numpy as np
import pytest

from repro.core import graphs as ref_graphs
from repro.core import metrics as ref_metrics
from repro.core import search as ref_search
from repro_torch.core import graphs, metrics, search

FIELDS = ("mpl", "diameter", "mpl_lb", "d_lb", "iterations", "accepted", "history",
          "replicas", "evals_delta", "evals_full", "device_dispatches", "offsets",
          "compound_steps", "objective_value")


def _equal_results(got, want):
    assert (got.graph.n, got.graph.edges, got.graph.name) == \
        (want.graph.n, want.graph.edges, want.graph.name)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f


SA_CASES = [(n, k, replicas, seed) for n, k in [(16, 4), (32, 3), (32, 4)]
            for replicas in (1, 4) for seed in (0, 3)]


@pytest.mark.parametrize("n,k,replicas,seed", SA_CASES)
def test_sa_search_matches_reference(n, k, replicas, seed):
    kw = dict(seed=seed, n_iter=500, replicas=replicas, exchange_every=150)
    got = search.sa_search(n, k, **kw)
    want = ref_search.sa_search(n, k, **kw)
    _equal_results(got, want)
    assert got.evals_delta + got.evals_full > 0 and got.graph.degree() == k


def test_sa_search_options_match_reference():
    """A reachable target stops early; a given start, other temperatures, and
    no iterations at all."""
    cases = [
        (16, 3, dict(seed=1, n_iter=3000, target_mpl=2.2)),
        (16, 4, dict(seed=2, n_iter=300, t_start=0.5, t_end=1e-3)),
        (12, 2, dict(seed=0, n_iter=50)),  # no chords: pure cooling
        (20, 4, dict(seed=5, n_iter=0)),
    ]
    for n, k, kw in cases:
        _equal_results(search.sa_search(n, k, **kw), ref_search.sa_search(n, k, **kw))
    start = graphs.random_hamiltonian_regular(18, 3, seed=9)
    ref_start = ref_graphs.random_hamiltonian_regular(18, 3, seed=9)
    _equal_results(search.sa_search(18, 3, seed=4, n_iter=400, replicas=2, start=start),
                   ref_search.sa_search(18, 3, seed=4, n_iter=400, replicas=2,
                                        start=ref_start))
    hit = search.sa_search(16, 3, seed=1, n_iter=3000, target_mpl=2.2)
    assert hit.mpl <= 2.2 + 1e-9


@pytest.mark.parametrize("n,girth_min,limit", [(12, 3, 2_000_000), (12, 4, 2_000_000),
                                               (12, 5, 2_000_000), (14, 3, 3000)])
def test_exhaustive_search_matches_reference(n, girth_min, limit):
    got = search.exhaustive_search(n, 3, girth_min=girth_min, limit=limit)
    want = ref_search.exhaustive_search(n, 3, girth_min=girth_min, limit=limit)
    _equal_results(got, want)
    if girth_min > 3:
        assert metrics.girth(got.graph) >= girth_min
    with pytest.raises(NotImplementedError):
        search.exhaustive_search(n, 4)


def test_sa_objective_search_matches_reference():
    def chord_span(g):
        # total ring distance spanned by the edges: a host objective both
        # packages evaluate identically
        return float(sum(min(v - u, g.n - (v - u)) for u, v in g.edges))

    for n, k, seed in [(16, 4, 0), (20, 3, 2)]:
        got = search.sa_objective_search(n, k, chord_span, seed=seed, n_iter=300)
        want = ref_search.sa_objective_search(n, k, chord_span, seed=seed, n_iter=300)
        assert (got.n, got.edges, got.name) == (want.n, want.edges, want.name)
        assert chord_span(got) <= chord_span(graphs.random_hamiltonian_regular(n, k, seed=seed))


def _random_swap(ev, ring_mask, rng):
    """A valid 2-edge swap on the evaluator's current graph, or None (the
    reference suite's draw)."""
    iu, ju = np.where(np.triu(ev.adj & ~ring_mask))
    if len(iu) < 2:
        return None
    e1, e2 = rng.choice(len(iu), size=2, replace=False)
    a, b = int(iu[e1]), int(ju[e1])
    c, d = int(iu[e2]), int(ju[e2])
    if len({a, b, c, d}) != 4:
        return None
    p1, p2 = ((a, c), (b, d)) if rng.integers(2) else ((a, d), (b, c))
    if ev.adj[p1] or ev.adj[p2]:
        return None
    return [(a, b), (c, d)], [p1, p2]


def _same_token(got, want):
    assert np.array_equal(got.dist, want.dist)
    assert (got.removed, got.added, got.total, got.diam, got.mpl) == \
        (want.removed, want.added, want.total, want.diam, want.mpl)


@pytest.mark.parametrize("n,k,seed,force", [
    (16, 4, 0, False), (24, 3, 1, False), (28, 5, 2, False), (20, 4, 3, True)])
def test_incremental_apsp_matches_reference(n, k, seed, force):
    adj = graphs.random_hamiltonian_regular(n, k, seed=seed).adjacency()
    ev = metrics.IncrementalAPSP(adj.copy(), force_full=force)
    ref = ref_metrics.IncrementalAPSP(adj.copy(), force_full=force, use_c=False)
    assert np.array_equal(ev.dist, ref.dist) and np.array_equal(ev.npar, ref.npar)
    ring_mask = graphs.ring(n).adjacency()
    rng = np.random.default_rng(seed + 100)
    priced = 0
    for _ in range(40):
        swap = _random_swap(ev, ring_mask, rng)
        if swap is None:
            continue
        tok, rtok = ev.evaluate_swap(*swap), ref.evaluate_swap(*swap)
        _same_token(tok, rtok)
        priced += 1
        if rng.random() < 0.6:
            ev.commit(tok)
            ref.commit(rtok)
            assert np.array_equal(ev.npar, ref.npar) and np.array_equal(ev.nbr, ref.nbr)
            assert (ev.total, ev.diam, ev.mpl(), ev.diameter()) == \
                (ref.total, ref.diam, ref.mpl(), ref.diameter())
    ev.verify()
    assert priced > 10
    assert (ev.n_delta, ev.n_full) == (ref.n_delta, ref.n_full)
    assert ev.n_full > 0 if force else ev.n_delta > 0
    # a batched change whose edges share vertices takes the same path
    iu, ju = np.nonzero(np.triu(ev.adj & ~ring_mask))
    removed = [(int(iu[0]), int(ju[0])), (int(iu[1]), int(ju[1]))]
    added = [(u, v) for u in range(n) for v in range(u + 2, n)
             if not ev.adj[u, v] and (v - u) % n != n - 1][:3]
    _same_token(ev.evaluate_swap(removed, added), ref.evaluate_swap(removed, added))
    assert (ev.n_delta, ev.n_full) == (ref.n_delta, ref.n_full)


def test_incremental_disconnecting_swap_and_recovery_match_reference():
    """The disconnect path (tests/test_incremental.py's case): inf MPL, the
    full path forced from a disconnected base, and the recovery."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (2, 6)]
    adj = graphs.from_edges(8, edges).adjacency()
    ev = metrics.IncrementalAPSP(adj.copy())
    ref = ref_metrics.IncrementalAPSP(adj.copy(), use_c=False)
    cut, rejoin = ([(0, 4), (2, 6)], [(0, 2), (4, 6)]), ([(0, 2), (4, 6)], [(0, 4), (2, 6)])
    tok, rtok = ev.evaluate_swap(*cut), ref.evaluate_swap(*cut)
    _same_token(tok, rtok)
    assert tok.mpl == float("inf")
    ev.commit(tok)
    ref.commit(rtok)
    ev.verify()
    assert not ev.connected and ev.mpl() == ev.diameter() == float("inf")
    assert np.array_equal(ev.as_float_dist(), ref.as_float_dist())
    tok, rtok = ev.evaluate_swap(*rejoin), ref.evaluate_swap(*rejoin)
    _same_token(tok, rtok)
    assert tok.mpl < float("inf")
    ev.commit(tok)
    ref.commit(rtok)
    ev.verify()
    assert ev.connected and (ev.n_delta, ev.n_full) == (ref.n_delta, ref.n_full)
    assert ev.n_full >= 1  # the swap from a disconnected base
    with pytest.raises(ValueError, match="not in the graph"):
        ev.evaluate_swap([(0, 5)], [])
    with pytest.raises(ValueError, match="already in the graph"):
        ev.evaluate_swap([], [(0, 1)])


def test_incremental_reset_and_load_from_match_reference():
    a = graphs.random_hamiltonian_regular(16, 4, seed=1).adjacency()
    b = graphs.random_hamiltonian_regular(16, 4, seed=2).adjacency()
    ev, ev_b = metrics.IncrementalAPSP(a.copy()), metrics.IncrementalAPSP(b.copy())
    ref = ref_metrics.IncrementalAPSP(a.copy(), use_c=False)
    ev.load_from(ev_b)
    ev.verify()
    assert ev.total == ev_b.total
    ev.adj[...] = a
    ev.reset()
    ev.verify()
    assert np.array_equal(ev.dist, ref.dist) and ev.total == ref.total
