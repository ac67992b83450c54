"""The port's host C fast path (``repro_torch.core._fastpath``) and the SA
tier that runs through it, against the JAX package's.

``fastpath.c`` is a byte-equal copy of the reference's C source; it builds
into the git-ignored ``kernels/_build/`` and a failed build raises with the
compiler's output.  ``IncrementalAPSP.evaluate_swap`` through the C
``eval_swap`` is held to the numpy evaluator (``_evaluate_swap_plain``) on
random 2+2 swaps, and ``sa_search`` through the C ``sa_chunk`` to the
reference's ``sa_search`` (its C path) and to the port's python mirror
(``_sa_chunk_py``), field by field.
"""
import functools

import numpy as np
import pytest

from repro.core import _fastpath as ref_fastpath
from repro.core import search as ref_search
from repro_torch.core import _fastpath, graphs, metrics, search

FIELDS = ("mpl", "diameter", "mpl_lb", "d_lb", "iterations", "accepted", "history",
          "replicas", "evals_delta", "evals_full", "device_dispatches", "offsets",
          "compound_steps", "objective_value")


def _fields(res) -> tuple:
    return ((res.graph.n, res.graph.edges, res.graph.name),
            *(getattr(res, f) for f in FIELDS))


def test_source_is_the_reference_source_byte_for_byte():
    assert _fastpath.SOURCE.read_bytes() == ref_fastpath._C_SOURCE.encode()


def test_library_builds_into_the_ignored_build_directory():
    path = _fastpath.build()
    assert path.is_file() and path.parent == _fastpath._BUILD
    assert path.parent.name == "_build" and path.parent.parent.name == "kernels"
    repo = _fastpath.SOURCE.parents[4]
    ignored = (repo / ".gitignore").read_text().split()
    assert path.parent.relative_to(repo).as_posix() + "/" in ignored, f"{path} is not ignored"
    lib = _fastpath.library()
    assert all(hasattr(lib, f) for f in ("apsp_rows", "parent_counts", "eval_swap", "sa_chunk"))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_fastpath, "_BUILD", tmp_path)
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match=r"C compiler failed \(exit 1\): false -O3"):
        _fastpath.build()
    assert not list(tmp_path.iterdir())  # no partial library left behind
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="failed to start"):
        _fastpath.build()
    # a compiler that writes a diagnostic: its text is in the error
    cc = tmp_path / "cc.sh"
    cc.write_text("#!/bin/sh\necho 'fastpath.c:1: error: simulated' >&2\nexit 3\n")
    cc.chmod(0o755)
    monkeypatch.setenv("CC", str(cc))
    with pytest.raises(RuntimeError, match="(?s)exit 3.*error: simulated"):
        _fastpath.build()


def test_bindings_refuse_buffers_of_the_wrong_dtype_shape_or_layout():
    nbr = metrics._nbr_table(graphs.ring(8).adjacency())
    scratch = np.zeros(64, np.int32)
    dist = np.empty((8, 8), np.int32)
    _fastpath.apsp_rows(nbr, dist, scratch)
    assert dist[0].tolist() == [0, 1, 2, 3, 4, 3, 2, 1]
    for bad in (np.empty((8, 8), np.int64), np.empty((8, 16), np.int32)[:, ::2],
                np.empty((8, 7), np.int32)):
        with pytest.raises(ValueError, match="apsp_rows|C-contiguous"):
            _fastpath.apsp_rows(nbr, bad, scratch)
    with pytest.raises(ValueError, match="npar"):
        _fastpath.parent_counts(nbr, dist, np.empty((8, 7), np.int16))
    rem, add = np.array([0, 1, 2, 3], np.int32), np.array([0, 2, 1, 3], np.int32)
    with pytest.raises(ValueError, match="8n scratch"):
        _fastpath.eval_swap(nbr, dist, np.empty((8, 8), np.int16), rem, add, False, 0.9, True,
                            0, np.empty((8, 8), np.int32), scratch[:10])


def _swap(adj, ring_mask, rng):
    """A random valid 2+2 swap with four distinct endpoints, or None."""
    iu, ju = np.where(np.triu(adj & ~ring_mask))
    if len(iu) < 2:
        return None
    e1, e2 = rng.choice(len(iu), size=2, replace=False)
    a, b, c, d = int(iu[e1]), int(ju[e1]), int(iu[e2]), int(ju[e2])
    if len({a, b, c, d}) != 4:
        return None
    p1, p2 = ((a, c), (b, d)) if rng.integers(2) else ((a, d), (b, c))
    if adj[p1] or adj[p2]:
        return None
    return [(a, b), (c, d)], [p1, p2]


def _same(tok, ptok):
    assert np.array_equal(tok.dist, ptok.dist)
    assert (tok.removed, tok.added, tok.total, tok.diam, tok.mpl) == \
        (ptok.removed, ptok.added, ptok.total, ptok.diam, ptok.mpl)


def _pair(adj, force=False):
    return (metrics.IncrementalAPSP(adj.copy(), force_full=force),
            metrics.IncrementalAPSP(adj.copy(), force_full=force))


@pytest.mark.parametrize("n,k,seed,force", [
    (16, 4, 0, False), (24, 3, 1, False), (32, 5, 2, False), (20, 4, 3, True), (12, 3, 4, False)])
def test_eval_swap_matches_plain_evaluator(n, k, seed, force):
    """Random 2+2 swaps through the C ``eval_swap`` and the numpy evaluator:
    rows, total, diameter and the delta/full counts; commits keep both
    states (distances, parent counts, neighbour table) equal."""
    adj = graphs.random_hamiltonian_regular(n, k, seed=seed).adjacency()
    ev, plain = _pair(adj, force)
    assert np.array_equal(ev.npar, metrics._parent_counts(ev.adj, ev.dist))
    ring_mask = graphs.ring(n).adjacency()
    rng = np.random.default_rng(seed + 7)
    priced = 0
    for _ in range(120):
        swap = _swap(ev.adj, ring_mask, rng)
        if swap is None:
            continue
        tok, ptok = ev.evaluate_swap(*swap), plain._evaluate_swap_plain(*swap)
        _same(tok, ptok)
        priced += 1
        assert (ev.n_delta, ev.n_full) == (plain.n_delta, plain.n_full)
        if tok.diam < n and rng.random() < 0.5:
            ev.commit(tok)
            plain.commit(ptok)
            assert np.array_equal(ev.npar, plain.npar) and np.array_equal(ev.nbr, plain.nbr)
            assert (ev.total, ev.diam) == (plain.total, plain.diam)
    ev.verify()
    assert priced > 20
    assert ev.n_full == priced if force else ev.n_delta > 0


def test_eval_swap_disconnecting_and_disconnected_base():
    """A swap that cuts the graph in two (inf MPL), committed, then priced
    from the disconnected base (forced full in both), and the recovery."""
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (2, 6)]
    adj = graphs.from_edges(8, edges).adjacency()
    ev, plain = _pair(adj)
    cut, rejoin = ([(0, 4), (2, 6)], [(0, 2), (4, 6)]), ([(0, 2), (4, 6)], [(0, 4), (2, 6)])
    tok, ptok = ev.evaluate_swap(*cut), plain._evaluate_swap_plain(*cut)
    _same(tok, ptok)
    assert tok.mpl == float("inf") and tok.diam == 8
    ev.commit(tok)
    plain.commit(ptok)
    assert not ev.connected
    full_before = ev.n_full
    tok, ptok = ev.evaluate_swap(*rejoin), plain._evaluate_swap_plain(*rejoin)
    _same(tok, ptok)
    assert ev.n_full == full_before + 1 == plain.n_full
    ev.commit(tok)
    ev.verify()
    assert ev.connected


def test_eval_swap_full_rebuild_past_nine_tenths():
    """Swaps whose removals affect more than 0.9 of the sources: the C path
    rebuilds every row, as the numpy path does, and counts it as full."""
    rng = np.random.default_rng(0)
    rebuilt = 0
    for seed in range(6):
        adj = graphs.random_hamiltonian_regular(10, 3, seed=seed).adjacency()
        ring_mask = graphs.ring(10).adjacency()
        for _ in range(40):
            swap = _swap(adj, ring_mask, rng)
            if swap is None:
                continue
            ev, plain = _pair(adj)
            aff = metrics._removal_affected(ev.dist, ev.npar, swap[0])
            _same(ev.evaluate_swap(*swap), plain._evaluate_swap_plain(*swap))
            assert (ev.n_delta, ev.n_full) == (plain.n_delta, plain.n_full)
            assert ev.n_full == int(aff.sum() > 0.9 * 10)
            rebuilt += ev.n_full
    assert rebuilt > 0


def test_batched_and_shared_vertex_changes_take_the_plain_path():
    adj = graphs.random_hamiltonian_regular(16, 4, seed=1).adjacency()
    ev, plain = _pair(adj)
    ring_mask = graphs.ring(16).adjacency()
    iu, ju = np.nonzero(np.triu(adj & ~ring_mask))
    removed = [(int(iu[0]), int(ju[0])), (int(iu[1]), int(ju[1])), (int(iu[2]), int(ju[2]))]
    added = [(u, v) for u in range(16) for v in range(u + 2, 16)
             if not adj[u, v] and (v - u) % 16 != 15][:3]
    _same(ev.evaluate_swap(removed, added), plain._evaluate_swap_plain(removed, added))
    absent = [(u, v) for u in range(16) for v in range(u + 1, 16) if not adj[u, v]]
    (a, b), (c, d) = absent[0], next(e for e in absent if not set(e) & set(absent[0]))
    with pytest.raises(ValueError, match="not in the graph"):
        ev.evaluate_swap([(a, b), (c, d)], [(a, c), (b, d)])
    with pytest.raises(ValueError, match="already in the graph"):
        ev.evaluate_swap([(int(iu[0]), int(ju[0])), (int(iu[1]), int(ju[1]))],
                         [(int(iu[2]), int(ju[2])), (int(iu[3]), int(ju[3]))])


SA_CASES = [(n, k, seed, replicas) for n, k in [(12, 3), (16, 4), (30, 5), (32, 4)]
            for seed in (0, 1, 2) for replicas in (1, 4)]


@pytest.mark.parametrize("n,k,seed,replicas", SA_CASES)
def test_sa_search_c_path_matches_reference_and_mirror(n, k, seed, replicas, monkeypatch):
    kw = dict(seed=seed, n_iter=600, replicas=replicas, exchange_every=150)
    got = search.sa_search(n, k, **kw)
    want = ref_search.sa_search(n, k, **kw)
    assert _fields(got) == _fields(want)
    monkeypatch.setattr(search, "_run_chunk", functools.partial(search._run_chunk, plain=True))
    mirror = search.sa_search(n, k, **kw)
    assert _fields(mirror) == _fields(got)
    assert got.evals_delta + got.evals_full > 0


def test_sa_search_c_path_runs_sa_chunk_and_keeps_the_evaluator_coherent(monkeypatch):
    calls = []
    real = _fastpath.sa_chunk

    def counting(**kw):
        calls.append(kw["chunk_iters"])
        return real(**kw)

    monkeypatch.setattr(_fastpath, "sa_chunk", counting)
    reps = []
    real_replica = search._Replica

    def keep(*a, **kw):
        reps.append(real_replica(*a, **kw))
        return reps[-1]

    monkeypatch.setattr(search, "_Replica", keep)
    res = search.sa_search(32, 4, seed=0, n_iter=1000, replicas=2, exchange_every=300,
                           target_mpl=None)
    assert calls == [300, 300, 300, 300, 300, 300, 100, 100]
    for rep in reps:
        ev = rep.ev
        ev.verify()  # dist, total, diameter and parent counts equal a recompute
        assert np.array_equal(ev.a32, ev.adj.astype(np.float32))
        assert (ev.total, ev.diam) == (rep.cur_total, rep.cur_diam)
    assert res.accepted == sum(int(r.stats[0]) for r in reps)


def test_optimal_builder_runs_the_c_path(monkeypatch):
    """``optimal:`` at n <= 64 goes through ``sa_search`` and the C path,
    with the reference's graph."""
    from repro.core import topologies as ref_topologies
    from repro_torch.core import topologies

    calls = []
    real = _fastpath.sa_chunk
    monkeypatch.setattr(_fastpath, "sa_chunk", lambda **kw: calls.append(1) or real(**kw))
    g = topologies.build_topology("optimal:20,4", device="cpu")
    want = ref_topologies.build_topology("optimal:20,4")
    assert calls and (g.n, g.edges, g.name) == (want.n, want.edges, want.name)
