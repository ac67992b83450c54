"""The port's large-N search tier (repro_torch.core.search) against the JAX
package's, on the CPU.

Both packages draw from the same numpy Generators and accept on exact
integer hop totals, so per seed every field of the result must be equal:
the graph, the MPL and its history, the counters.  The reference prices with
its Pallas kernels in interpret mode (``engine="pallas"``); the port with its
kernels' plain PyTorch versions (``device="cpu"``).
"""
import numpy as np
import pytest

from repro.core import graphs as ref_graphs
from repro.core import known_optimal as ref_known
from repro.core import metrics as ref_metrics
from repro.core import search as ref_search
from repro_torch import convert
from repro_torch.core import graphs, known_optimal, metrics, search

FIELDS = ("mpl", "diameter", "mpl_lb", "d_lb", "iterations", "accepted",
          "history", "evals_delta", "evals_full", "device_dispatches",
          "replicas", "offsets")

# (64, 4) has no pinned offsets: the hillclimb runs; (256, 6) is pinned
LARGE_CASES = [
    dict(n=64, k=4, budget=10, replicas=2, delta=True, proposal_batch=1),
    dict(n=64, k=4, budget=10, replicas=3, delta=False, proposal_batch=2),
    dict(n=256, k=6, polish_iters=12, replicas=3, delta=True, proposal_batch=2),
    dict(n=256, k=6, polish_iters=12, replicas=2, delta=False, proposal_batch=1),
]


@pytest.mark.parametrize("kw", LARGE_CASES,
                         ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()))
def test_large_search_matches_reference(kw):
    want = ref_search.large_search(seed=0, fold=4, engine="pallas", **kw)
    got = search.large_search(seed=0, fold=4, device="cpu", **kw)
    assert got.graph.edges == want.graph.edges
    assert got.graph.n == want.graph.n
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.evals_delta + got.evals_full > 0 and got.device_dispatches > 1


def test_large_search_replicas_1_not_ported():
    """``replicas=1`` (the default), once refused, now polishes with
    ``symmetric_sa_search`` as the reference does: every field equal, on an
    unpinned (64, 4), where the hillclimb runs, and on the pinned (256, 6)."""
    for kw in (dict(n=64, k=4, budget=10), dict(n=256, k=6, polish_iters=12)):
        want = ref_search.large_search(seed=0, fold=4, engine="bitset", **kw)
        got = search.large_search(seed=0, fold=4, device="cpu", **kw)
        assert got.graph.edges == want.graph.edges
        for f in FIELDS + ("compound_steps",):
            assert getattr(got, f) == getattr(want, f), f
        assert got.evals_delta + got.evals_full > 0  # the polish won
    # no polish requested: the circulant stage alone runs
    got = search.large_search(64, 4, budget=10, polish=False, device="cpu")
    want = ref_search.large_search(64, 4, budget=10, polish=False)
    assert got.graph.edges == want.graph.edges and got.mpl == want.mpl


@pytest.mark.parametrize("n,k,seed,n_iter", [(64, 4, 0, 60), (96, 6, 3, 80),
                                             (50, 5, 1, 40)])
def test_circulant_search_matches_reference_trajectory(n, k, seed, n_iter):
    got = search.circulant_search(n, k, seed=seed, n_iter=n_iter)
    want = ref_search.circulant_search(n, k, seed=seed, n_iter=n_iter,
                                       engine="numpy")
    assert got.graph.edges == want.graph.edges
    for f in ("mpl", "diameter", "iterations", "accepted", "history", "offsets"):
        assert getattr(got, f) == getattr(want, f), f


def test_known_offsets_and_host_helpers_equal_reference():
    assert known_optimal.KNOWN_CIRCULANT_OFFSETS == ref_known.KNOWN_CIRCULANT_OFFSETS
    assert len(known_optimal.KNOWN_CIRCULANT_OFFSETS) == 21
    for n, k in [(16, 3), (256, 6), (8192, 8), (1000, 5)]:
        assert metrics.mpl_lower_bound(n, k) == ref_metrics.mpl_lower_bound(n, k)
        assert metrics.diameter_lower_bound(n, k) == \
            ref_metrics.diameter_lower_bound(n, k)
    assert graphs.ring(9).edges == ref_graphs.ring(9).edges
    g, h = graphs.circulant(40, [1, 7, 20]), ref_graphs.circulant(40, [1, 7, 20])
    assert (g.edges, g.name) == (h.edges, h.name)
    g5, h5 = graphs.from_edges(5, [(3, 1), (0, 4)]), ref_graphs.from_edges(5, [(3, 1), (0, 4)])
    assert (g5.n, g5.edges, g5.name) == (h5.n, h5.edges, h5.name)
    adj = g.adjacency()
    assert np.array_equal(adj, h.adjacency())
    nbr = metrics._nbr_table(adj, 6)
    assert np.array_equal(nbr, ref_metrics._nbr_table(adj, 6))
    dist = ref_metrics.bitset_bfs_rows(nbr, np.arange(10), 40)
    removed = [(0, 1), (7, 8), (3, 23)]
    assert np.array_equal(metrics._removal_affected_nbr(dist, nbr, removed),
                          ref_metrics._removal_affected_nbr(dist, nbr, removed))
    assert np.array_equal(metrics._parent_count_cols(dist, nbr, [0, 5, 39]),
                          ref_metrics._parent_count_cols(dist, nbr, [0, 5, 39]))
    for u, v in [(0, 5), (3, 60)]:
        assert search._orbit(64, 16, u, v) == ref_search._orbit(64, 16, u, v)
    assert search._circulant_orbits(64, 16, (1, 2, 9)) == \
        ref_search._circulant_orbits(64, 16, (1, 2, 9))
    assert search._circulant_profile(64, (1, 9)) == \
        ref_search._circulant_profile(64, (1, 9))


class _RefChain:
    def __init__(self, dist, nbr):
        self.dist, self.nbr = dist, nbr


def test_resync_check_through_converted_reference_state():
    """State carried over from the reference (convert) passes the port's
    drift guard exactly when it passes the reference's; a corrupted host
    mirror or device copy raises AssertionError in both."""
    n, s = 64, 16
    adj = ref_graphs.circulant(n, (1, 2, 9)).adjacency()
    ev = ref_metrics.SymmetricAPSP(adj, s, engine="numpy", use_c=False)
    nbr = ref_metrics._nbr_table(adj)
    dist = ev.dist.astype(np.int32)
    orbs = ref_search._circulant_orbits(n, s, (1, 2, 9))
    good = convert.chain_state_from_reference(nbr, dist, orbs, device="cpu")
    assert np.array_equal(good.nbr, nbr) and np.array_equal(good.dist, dist)
    assert np.array_equal(good.adj, adj) and set(good.orb_list) == orbs
    ref_search._resync_check([_RefChain(dist, nbr)], s, n, use_pallas=True)
    search._resync_check([good], s, n)  # exact state: no raise

    bad_dist = dist.copy()
    bad_dist[3, 17] += 1  # simulated drift
    with pytest.raises(AssertionError, match="drift"):
        ref_search._resync_check([_RefChain(dist, nbr), _RefChain(bad_dist, nbr)],
                                 s, n, use_pallas=True)
    bad = convert.chain_state_from_reference(nbr, bad_dist, orbs, device="cpu")
    with pytest.raises(AssertionError, match="drift"):
        search._resync_check([good, bad], s, n)
    mirror = convert.chain_state_from_reference(nbr, dist, orbs, device="cpu")
    mirror.dist = bad_dist  # host mirror drifts from the device copy
    with pytest.raises(AssertionError, match="drift"):
        search._resync_check([mirror], s, n)


def test_replica_polish_resync_in_walk():
    """resync_every=4: every in-walk drift guard stays silent, and the
    trajectory equals the reference's under the same schedule."""
    orbits = ref_search._circulant_orbits(64, 16, (2, 9))
    kw = dict(seed=0, n_iter=16, fold=4, start_orbits=orbits, replicas=2,
              exchange_every=8, delta=True, resync_every=4)
    got = search._replica_polish(64, 4, device="cpu", **kw)
    want = ref_search._replica_polish(64, 4, engine="bitset", **kw)
    assert got.graph.edges == want.graph.edges
    assert (got.history, got.accepted, got.device_dispatches) == \
        (want.history, want.accepted, want.device_dispatches)
    with pytest.raises(ValueError, match="proposal_batch"):
        search._replica_polish(64, 4, device="cpu", proposal_batch=0, **kw)
