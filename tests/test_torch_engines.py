"""The port's batched pricers (repro_torch.core.engines.cuda_sweep) against the
JAX package's (repro.core.engines.pallas_sweep, Pallas kernels in interpret
mode), on the CPU.  Inputs are made with numpy from a seed; totals, maxima and
the full distance state must be equal."""
import numpy as np
import pytest

from repro.core import metrics as ref_metrics
from repro.core.engines import pallas_sweep
from repro.core.graphs import circulant as ref_circulant
from repro_torch.core.engines import cuda_sweep


def _nbr(n, offsets, kmax=None):
    return ref_metrics._nbr_table(ref_circulant(n, offsets).adjacency(), kmax)


def test_sharded_rows_totals_matches_reference():
    n, m = 60, 15
    nbrs = np.stack([_nbr(n, offs, 4) for offs in ([1, 7], [1, 11], [2, 4])])
    got = cuda_sweep.sharded_rows_totals(nbrs, m, n, device="cpu")
    want = pallas_sweep.sharded_rows_totals(nbrs, m, n, use_pallas=True)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[1][2] == n  # the disconnected graph reports the sentinel


def _check_delta(base, nbrs, srcs, patches, n):
    got = cuda_sweep.sharded_delta_state(base, nbrs, srcs, patches, n, device="cpu")
    want = pallas_sweep.sharded_delta_state(base, nbrs, srcs, patches, n,
                                            use_pallas=True)
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert got[1].dtype == want[1].dtype and np.array_equal(got[1], want[1])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    return got


def test_sharded_delta_state_idle_lanes_and_no_patch():
    """Two chains x three proposals: varying affected-row counts (idle lanes
    carry id == s and must drop out of the merge), one proposal with no
    affected rows and no patch, one full-row re-sweep."""
    rng = np.random.default_rng(0)
    n, s = 64, 16
    g0, g1 = _nbr(n, [1, 5], 4), _nbr(n, [1, 9], 4)
    base = np.stack([ref_metrics.bitset_bfs_rows(g, np.arange(s), n)
                     for g in (g0, g1)])
    nbrs = np.stack([g0, g0, g0, g1, g1, g1])
    srcs = [np.sort(rng.choice(s, 5, replace=False)), np.empty(0, np.int64),
            np.arange(s), np.array([3]), np.sort(rng.choice(s, 9, replace=False)),
            np.array([0, 15])]
    patches = [[(0, 13)], None, None, [(2, 40), (3, 41)], [(5, 6)], [(1, 33)]]
    got = _check_delta(base, nbrs, srcs, patches, n)
    assert np.array_equal(got[2][1].numpy(), base[0])  # nothing re-swept or patched


def test_sharded_delta_state_disconnect_and_recovery():
    """Removing the whole ring orbit disconnects C16(1, 8); adding offset-3
    chords reconnects it, offset-2 chords do not (tests/test_search.py's
    case): sentinel-coded rows stay exact both ways."""
    n, s = 16, 4
    adj = ref_circulant(n, (1, 8)).adjacency()
    ring_orbit = sorted((min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n))
    ev = ref_metrics.SymmetricAPSP(adj, s, full_rebuild_frac=1.0, use_c=False,
                                   engine="numpy")
    adj_rm = adj.copy()
    for u, v in ring_orbit:
        adj_rm[u, v] = adj_rm[v, u] = False
    kmax = ref_metrics._nbr_table(adj).shape[1]
    aff = ref_metrics._removal_affected_nbr(ev.dist, ev.nbr, ring_orbit)
    chords = {off: sorted((min(i, (i + off) % n), max(i, (i + off) % n))
                          for i in range(n)) for off in (2, 3)}
    base = np.stack([ev.dist.astype(np.int32)] * 2)
    nbrs = np.stack([ref_metrics._nbr_table(adj_rm, kmax)] * 6)
    srcs = [np.nonzero(aff)[0]] * 6
    patches = [None, chords[3], chords[2], None, chords[3], chords[2]]
    tot, mx, _ = _check_delta(base, nbrs, srcs, patches, n)
    assert list(mx[:3] == n) == [True, False, True]


def test_delta_batch_not_multiple_of_replicas_and_int32_guard():
    n, s = 16, 4
    g = _nbr(n, [1, 5])
    base = np.zeros((2, s, n), np.int32)
    with pytest.raises(ValueError, match="multiple of replicas"):
        cuda_sweep.sharded_delta_state(base, np.stack([g] * 3), [[0]] * 3,
                                       [None] * 3, n, device="cpu")
    huge = np.iinfo(np.int32).max // n + 1
    with pytest.raises(NotImplementedError, match="int32"):
        cuda_sweep.sharded_delta_state(base, np.stack([g] * 2), [[0]] * 2,
                                       [None] * 2, huge, device="cpu")
    with pytest.raises(NotImplementedError, match="int32"):
        cuda_sweep.sharded_rows_totals(np.stack([g]), s, huge, device="cpu")
