"""The port's symmetric orbit polish (repro_torch.core.metrics.SymmetricAPSP and
repro_torch.core.search.symmetric_sa_search) against the JAX package's, on the
CPU.

Both packages draw from the same numpy Generators and price on exact integer
hop counts, so every token (distance rows, total, diameter, MPL), every
counter and every field of a search result must be equal.  The reference
prices with its host engines ("numpy", "bitset") and, in one case, its Pallas
kernel in interpret mode; the port with its kernels' plain PyTorch versions
(``device="cpu"``).
"""
import numpy as np
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core import search as ref_search
from repro.core.graphs import circulant
from repro_torch.core import metrics, search

FIELDS = ("mpl", "diameter", "mpl_lb", "d_lb", "iterations", "accepted",
          "history", "evals_delta", "evals_full", "device_dispatches",
          "replicas", "offsets", "compound_steps")


def _same_result(got, want):
    assert got.graph.n == want.graph.n
    assert got.graph.edges == want.graph.edges
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _random_orbit_swap(adj, n, s, rng):
    """A random orbit-level swap of the graph ``adj`` (tests/test_incremental's
    draw): orbit-closed (removed, added) lists with overlap cancelled, or
    None for an invalid draw."""
    fold = n // s
    iu, ju = np.nonzero(np.triu(adj))
    e1, e2 = rng.choice(len(iu), size=2, replace=False)
    o1 = ref_search._orbit(n, s, int(iu[e1]), int(ju[e1]))
    o2 = ref_search._orbit(n, s, int(iu[e2]), int(ju[e2]))
    if o1 == o2:
        return None
    (u1, v1), (u2, v2) = next(iter(o1)), next(iter(o2))
    tshift = int(rng.integers(fold)) * s
    if rng.integers(2):
        na, nb = (u1, (v2 + tshift) % n), ((u2 + tshift) % n, v1)
    else:
        na, nb = (u1, (u2 + tshift) % n), (v1, (v2 + tshift) % n)
    if na[0] == na[1] or nb[0] == nb[1]:
        return None
    new_edges = set(ref_search._orbit(n, s, *na)) | set(ref_search._orbit(n, s, *nb))
    cur = {(int(u), int(v)) for u, v in zip(iu, ju)}
    old_edges = set(o1) | set(o2)
    if new_edges & (cur - old_edges):
        return None
    removed = sorted(old_edges - new_edges)
    added = sorted(new_edges - old_edges)
    if not removed and not added:
        return None
    return removed, added


def _same_token(tok, want):
    assert tok.dist.dtype == torch.int32
    assert np.array_equal(tok.dist.numpy(), want.dist)
    assert (tok.total, tok.diam, tok.mpl) == (want.total, want.diam, want.mpl)
    assert (tok.removed, tok.added) == (want.removed, want.added)


# the shapes of tests/test_incremental.py's orbit property tests
SHAPES = [(12, 3), (16, 4), (24, 4), (24, 6), (30, 5)]
MODES = {"delta": dict(full_rebuild_frac=1.1), "full": dict(force_full=True),
         "default": dict()}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda sh: f"s{sh[0]}-fold{sh[1]}")
def test_orbit_swaps_match_reference_engines(shape, mode):
    """Random orbit swap sequences, committed at random: every token equals
    the reference's "numpy" and "bitset" tokens, ``verify`` passes after
    every commit, and the delta/full counters equal the reference's."""
    s, fold = shape
    n = s * fold
    kw = MODES[mode]
    for seed in (0, 1):
        rng = np.random.default_rng(seed + 10 * s + fold)
        offs = [1] + sorted(rng.choice(range(2, n // 2), size=2, replace=False).tolist())
        adj = circulant(n, offs).adjacency()
        refs = {e: ref_metrics.SymmetricAPSP(adj.copy(), shift=s, engine=e, **kw)
                for e in ("numpy", "bitset")}
        ev = metrics.SymmetricAPSP(adj.copy(), shift=s, device="cpu", **kw)
        assert np.array_equal(ev.dist.numpy(), refs["numpy"].dist)
        assert np.array_equal(ev.npar, refs["numpy"].npar)
        priced = 0
        for _ in range(8):
            swap = _random_orbit_swap(ev.adj, n, s, rng)
            if swap is None:
                continue
            tok = ev.evaluate_swap(*swap)
            wants = {e: r.evaluate_swap(*swap) for e, r in refs.items()}
            for want in wants.values():
                _same_token(tok, want)
            priced += 1
            if rng.random() < 0.7:
                ev.commit(tok)
                for e, r in refs.items():
                    r.commit(wants[e])
                ev.verify()
                assert np.array_equal(ev.npar, refs["bitset"].npar)
                assert (ev.total, ev.diam) == (refs["numpy"].total, refs["numpy"].diam)
        assert priced > 0
        for r in refs.values():
            assert (ev.n_delta, ev.n_full) == (r.n_delta, r.n_full)
        if mode == "full":
            assert ev.n_delta == 0 and ev.n_full == priced


def test_disconnecting_swap_and_recovery_match_reference():
    """Removing the ring orbit disconnects C_24(1, 8) (tokens at inf, the
    sentinel rows exact); the next swap restores it through the forced full
    path (a disconnected base), with the reference's counters."""
    n, s = 24, 6
    adj = circulant(n, [1, 8]).adjacency()
    ev = metrics.SymmetricAPSP(adj.copy(), shift=s, device="cpu")
    ref = ref_metrics.SymmetricAPSP(adj.copy(), shift=s, engine="bitset")
    ring_orbit = sorted({(i, (i + 1) % n) if i + 1 < n else (0, n - 1)
                         for i in range(n)})
    tok, want = ev.evaluate_swap(ring_orbit, []), ref.evaluate_swap(ring_orbit, [])
    _same_token(tok, want)
    assert tok.mpl == float("inf") and tok.diam == n
    ev.commit(tok)
    ref.commit(want)
    ev.verify()
    assert not ev.connected and ev.mpl() == ev.diameter() == float("inf")
    counts = (ev.n_delta, ev.n_full)
    tok, want = ev.evaluate_swap([], ring_orbit), ref.evaluate_swap([], ring_orbit)
    _same_token(tok, want)
    assert (ev.n_delta, ev.n_full) == (counts[0], counts[1] + 1)
    assert tok.mpl < float("inf")
    ev.commit(tok)
    ref.commit(want)
    ev.verify()
    assert ev.connected and ev.mpl() == ref.mpl()
    assert (ev.n_delta, ev.n_full) == (ref.n_delta, ref.n_full)


def test_compound_proposal_matches_reference():
    """Three 2-orbit moves merged into one proposal, as symmetric_sa_search
    merges them: 48 added-edge endpoints, so the patch is packed at mmax 64
    (the kernel's tile instantiation on the card)."""
    n, k, fold = 256, 6, 4
    s = n // fold
    offs = ref_search.large_search(n, k, seed=0, polish=False).offsets
    orbits = sorted(search._circulant_orbits(n, s, offs), key=sorted)
    chords = {e for orb in orbits for e in orb}
    ring = {(i, (i + 1) % n) for i in range(n - 1)} | {(0, n - 1)}
    rng = np.random.default_rng(0)
    work_list, work_chords, moves = orbits, chords, 0
    while moves < 3:
        mv = search._draw_orbit_swap(rng, work_list, work_chords, ring, n, s, fold)
        if mv is None:
            continue
        i1, i2, no1, no2, new_edges, remaining = mv
        work_list = [o for i, o in enumerate(work_list) if i not in (i1, i2)] + [no1, no2]
        work_chords = remaining | new_edges
        moves += 1
    removed, added = sorted(chords - work_chords), sorted(work_chords - chords)
    assert len({x for e in added for x in e}) > 32
    adj = circulant(n, offs).adjacency()
    ev = metrics.SymmetricAPSP(adj.copy(), shift=s, device="cpu")
    ref = ref_metrics.SymmetricAPSP(adj.copy(), shift=s, engine="numpy")
    tok, want = ev.evaluate_swap(removed, added), ref.evaluate_swap(removed, added)
    _same_token(tok, want)
    assert (ev.n_delta, ev.n_full) == (ref.n_delta, ref.n_full) == (1, 0)
    ev.commit(tok)
    ev.verify()


def test_symmetric_evaluator_rejects_bad_input():
    adj = circulant(24, [1, 5]).adjacency()
    asym = adj.copy()
    asym[0, 9] = asym[9, 0] = True  # break the rotational symmetry
    with pytest.raises(ValueError, match="not invariant"):
        metrics.SymmetricAPSP(asym, shift=6, device="cpu")
    with pytest.raises(ValueError, match="divisor"):
        metrics.SymmetricAPSP(adj, shift=7, device="cpu")
    ev = metrics.SymmetricAPSP(adj, shift=6, device="cpu")
    with pytest.raises(ValueError, match="not closed"):
        ev.evaluate_swap([(0, 5)], [])  # single edge, orbit has 4
    with pytest.raises(ValueError, match="not closed"):
        ev.evaluate_swap([], [(0, 9)])
    with pytest.raises(ValueError, match="not in the graph"):
        ev.evaluate_swap(sorted(search._orbit(24, 6, 0, 3)), [])
    with pytest.raises(ValueError, match="already in the graph"):
        ev.evaluate_swap([], sorted(search._orbit(24, 6, 0, 5)))
    assert ev.n_delta == ev.n_full == 0


def test_delta_pricing_pulls_columns_not_the_state():
    """A delta evaluation copies home only the lost-parent test's columns
    and the (s,) row sums, far less than the (s, n) state; the counted
    uploads are the packed sweep inputs and the patch's small arrays."""
    n, k, fold = 384, 4, 4
    s = n // fold
    res = ref_search.circulant_search(n, k, seed=0, n_iter=40, engine="numpy")
    adj = circulant(n, res.offsets).adjacency()
    ev = metrics.SymmetricAPSP(adj, shift=s, device="cpu")
    state_bytes = s * n * 4
    rng = np.random.default_rng(0)
    deltas = 0
    while deltas < 6:
        swap = _random_orbit_swap(ev.adj, n, s, rng)
        if swap is None:
            continue
        before = (ev.bytes_to_host, ev.bytes_to_device, ev.n_delta)
        ev.evaluate_swap(*swap)
        if ev.n_delta == before[2]:
            continue
        deltas += 1
        cols = {x for e in swap[0] for x in e}
        cols |= {int(w) for x in cols for w in ev.nbr[x] if w >= 0}
        assert ev.bytes_to_host - before[0] == (len(cols) * s + s + 1) * 4
        assert ev.bytes_to_host - before[0] < state_bytes // 2
        assert ev.bytes_to_device - before[1] < state_bytes


# symmetric_sa_search: every field of the result against the reference
SA_CASES = [
    ((48, 4), dict(seed=0, n_iter=300, fold=4), "bitset"),
    ((64, 6), dict(seed=3, n_iter=300, fold=4), "bitset"),
    ((48, 4), dict(seed=0, n_iter=150, fold=4), "pallas"),
    # the compound case of tests/test_search.py
    ((64, 6), dict(seed=0, n_iter=800, fold=4, t_start=1e-6, t_end=1e-9,
                   start_offsets=(1, 9, 23), moves_per_step=3), "bitset"),
]


@pytest.mark.parametrize("args,kw,engine", SA_CASES,
                         ids=["48-4-bitset", "64-6-bitset", "48-4-pallas", "64-6-compound"])
def test_symmetric_sa_search_matches_reference(args, kw, engine):
    want = ref_search.symmetric_sa_search(*args, engine=engine, **kw)
    got = search.symmetric_sa_search(*args, device="cpu", **kw)
    _same_result(got, want)
    assert got.evals_delta > 0 and got.evals_full > 0
    if "moves_per_step" in kw:
        assert got.compound_steps > 0


@pytest.mark.parametrize("n,k,seed", [(48, 4, 0), (64, 6, 3)])
def test_symmetric_sa_search_dense_pricing_matches_reference(n, k, seed):
    """incremental=False prices on the host (``_mpl_fast``): the same
    trajectory as the reference's, and as the port's incremental pricing."""
    kw = dict(seed=seed, n_iter=120, fold=4)
    got = search.symmetric_sa_search(n, k, incremental=False, device="cpu", **kw)
    _same_result(got, ref_search.symmetric_sa_search(n, k, incremental=False, **kw))
    assert got.evals_delta == got.evals_full == 0
    inc = search.symmetric_sa_search(n, k, device="cpu", **kw)
    assert (inc.graph.edges, inc.mpl, inc.history, inc.accepted) == \
        (got.graph.edges, got.mpl, got.history, got.accepted)


def test_symmetric_sa_search_start_offsets_equal_start_orbits():
    n, k, offs = 64, 6, (1, 9, 23)
    kw = dict(seed=1, n_iter=60, fold=4)
    a = search.symmetric_sa_search(n, k, start_offsets=offs, device="cpu", **kw)
    orbits = search._circulant_orbits(n, n // 4, offs)
    b = search.symmetric_sa_search(n, k, start_orbits=orbits, device="cpu", **kw)
    _same_result(a, b)
    _same_result(a, ref_search.symmetric_sa_search(n, k, start_orbits=orbits,
                                                   engine="bitset", **kw))


def test_symmetric_sa_search_validation():
    with pytest.raises(ValueError, match="moves_per_step"):
        search.symmetric_sa_search(16, 4, n_iter=10, fold=4, moves_per_step=0,
                                   device="cpu")
    for bad_fold in (0, -2, 3, 2.5, 100):
        with pytest.raises(ValueError, match="fold"):
            search.symmetric_sa_search(16, 4, n_iter=10, fold=bad_fold, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        search.symmetric_sa_search(64, 6, n_iter=10, fold=4, start_offsets=(1, 9, 23),
                                   start_orbits=search._circulant_orbits(64, 16, (1, 9, 23)),
                                   device="cpu")


def test_symmetric_host_helpers_equal_reference():
    for n, k, s, seed in [(48, 4, 12, 0), (64, 6, 16, 3), (30, 3, 10, 1)]:
        a = search._symmetric_random_start(n, k, s, np.random.default_rng(seed))
        b = ref_search._symmetric_random_start(n, k, s, np.random.default_rng(seed))
        assert a == b
    adj = circulant(60, [1, 7, 18]).adjacency()
    for src in (None, 15):
        assert search._mpl_fast(adj, src) == ref_search._mpl_fast(adj, src)
    dist = ref_metrics.apsp_hops(adj)[:15]
    assert np.array_equal(metrics._parent_counts(adj, dist),
                          ref_metrics._parent_counts(adj, dist))
    assert np.array_equal(metrics._bfs_rows(adj.astype(np.float32), np.arange(60), 60),
                          ref_metrics.apsp_hops(adj))
    assert (search._COMPOUND_WINDOW, search._COMPOUND_RATE) == \
        (ref_search._COMPOUND_WINDOW, ref_search._COMPOUND_RATE)


def test_symmetric_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        metrics.SymmetricAPSP(circulant(24, [1, 5]).adjacency(), shift=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        search.symmetric_sa_search(48, 4, n_iter=5, fold=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        search.symmetric_sa_search(48, 4, n_iter=5, fold=4, incremental=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        search.large_search(64, 4, budget=10)
