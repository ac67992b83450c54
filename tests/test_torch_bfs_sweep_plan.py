"""The instantiation plan of ``bfs_sweep_kernel`` (repro_torch.kernels.bfs_sweep.
sweep_plan) and the small batches that reach each of the kernel's branches,
run through the port's ``sweep`` on the CPU against the JAX package.

The plan is pure Python, so its choice and its shared-memory bytes are held
here; the kernel itself runs only on the card (``chip_smoke.py`` phase 3
runs these cases there, with n = 16384 and n = MAX_SWEEP_N besides).  On
the CPU ``sweep`` runs its plain version, which must equal the reference's
packed sweep bit for bit on every case.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core.graphs import circulant as ref_circulant
from repro.kernels import bfs_sweep as ref_bs
from repro_torch.kernels import bfs_sweep as bs

CPU = torch.device("cpu")


def _nbr(n, offsets, kmax=None):
    return ref_metrics._nbr_table(ref_circulant(n, offsets).adjacency(), kmax)


@pytest.mark.parametrize("n,kmax,want", [
    (8192, 8, bs.SweepPlan("shared", 1024, 8, 2 * 8196 * 4 + 8192 * 16)),
    (16384, 8, bs.SweepPlan("global", 1024, 16, 2 * 16384 * 4)),
    (bs.MAX_SWEEP_N, 8, bs.SweepPlan("global", 1024, 32, bs.SMEM_BYTES)),
    (2048, 6, bs.SweepPlan("shared", 1024, 2, 2 * 2052 * 4 + 2048 * 16)),
    (2048, 12, bs.SweepPlan("global", 1024, 2, 2 * 2048 * 4)),
    (130, 5, bs.SweepPlan("shared", 160, 1, 2 * 132 * 4 + 130 * 16)),
    (1000, 6, bs.SweepPlan("shared", 1024, 1, 2 * 1004 * 4 + 1000 * 16)),
    (8193, 8, bs.SweepPlan("global", 1024, 16, 2 * 8193 * 4)),
])
def test_sweep_plan_choice_and_bytes(n, kmax, want):
    """The polish's (8192, 8) takes the shared-memory table; the largest
    pinned n (16384) and MAX_SWEEP_N read the rows from device memory."""
    assert bs.sweep_plan(n, kmax) == want


def test_sweep_plan_fits_and_covers_every_shape():
    for n in (1, 31, 32, 33, 1023, 1024, 1025, 4097, 8191, 8192, 8193, 20000,
              bs.MAX_SWEEP_N):
        for kmax in (0, 1, 5, 8, 9, 16, 40):
            plan = bs.sweep_plan(n, kmax)
            assert plan.smem_bytes <= bs.SMEM_BYTES
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
            assert plan.vpt & (plan.vpt - 1) == 0  # a power of two
            assert plan.threads * plan.vpt >= n
            assert (plan.graph == "shared") == (kmax <= 8 and plan.vpt <= 8)


@pytest.mark.parametrize("n", [0, bs.MAX_SWEEP_N + 1, 46340])
def test_sweep_plan_raises_outside_the_kernels_domain(n):
    with pytest.raises(ValueError, match="shared memory"):
        bs.sweep_plan(n, 8)


def _kmax5_midrow_pads():
    rng = np.random.default_rng(3)
    nbr = _nbr(130, [1, 9], 5)
    nbr[::7, 1] = -1
    perm = rng.permuted(np.tile(np.arange(5), (130, 1)), axis=1)
    return np.take_along_axis(nbr, perm, 1)


# (label, nbr table, sources): the edge cases of chip_smoke.py phase 3 that
# are small enough for the CPU
ROW_CASES = [
    ("kmax 5, -1 pads mid-row", _kmax5_midrow_pads, np.arange(130)),
    ("n=1000, ragged block", lambda: _nbr(1000, [1, 23, 100], 6), np.arange(0, 1000, 7)),
    ("disconnected", lambda: _nbr(600, [2, 10], 4), np.arange(0, 600, 5)),
    ("ring, 100 levels", lambda: _nbr(200, [1], 2), np.arange(0, 200, 40)),
    ("kmax 12", lambda: _nbr(2048, [1, 3, 17, 99, 301, 700], 12), np.arange(64)),
]


@pytest.mark.parametrize("label,make,srcs", ROW_CASES, ids=[c[0] for c in ROW_CASES])
def test_sweep_edge_cases_match_reference(label, make, srcs):
    nbr = make()
    n = nbr.shape[0]
    got = bs.bfs_rows(nbr, srcs, n, device="cpu")
    want = np.asarray(ref_bs.bfs_rows(nbr, srcs, n))
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref_metrics.bitset_bfs_rows(nbr, srcs, n))
    if label == "disconnected":
        assert (got == n).any()
    if label.startswith("kmax 5"):
        assert (nbr[:, 1:-1] < 0).any()  # a pad inside a row


def test_sweep_zero_seed_word_and_bit31_match_reference():
    """Three seed words, the middle one all zero, sources in bit 31."""
    n = 200
    nb, vm = bs.pack_nbr(_nbr(n, [1, 13], 4))
    F0 = np.zeros((n, 3), dtype=np.uint32)
    F0[17, 0] = np.uint32(1 << 31)
    F0[5, 0] = 1
    F0[199, 2] = np.uint32(1 | 1 << 31)
    got = bs.sweep(*(bs.as_words(a[None], CPU) for a in (nb, vm, F0)), n)[0]
    want = ref_bs.sweep_rows_ref(jnp.asarray(nb), jnp.asarray(vm), jnp.asarray(F0), n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (got[32:64] == n).all()  # the zero word's rows: all sentinel


def test_sweep_partial_vm_words_match_reference():
    """vm words other than 0 and 0xFFFFFFFF, which no packer makes: the
    kernel applies them exactly; the plain version and the reference's
    jnp sweep agree on them."""
    n = 512
    rng = np.random.default_rng(4)
    nb, vm = bs.pack_nbr(_nbr(n, [1, 5, 77], 6))
    part = rng.random(vm.shape) < 0.5
    vm[part] = rng.integers(0, 2**32, size=int(part.sum()), dtype=np.uint32)
    F0 = bs.pack_frontier(n, np.arange(96), 3)
    got = bs.sweep(*(bs.as_words(a[None], CPU) for a in (nb, vm, F0)), n)[0]
    want = ref_bs.sweep_rows_ref(jnp.asarray(nb), jnp.asarray(vm), jnp.asarray(F0), n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    full = bs.bfs_rows(_nbr(n, [1, 5, 77], 6), np.arange(96), n, device="cpu")
    assert not np.array_equal(got[:96].numpy(), full)  # the partial words mattered


def test_sweep_batch_longer_than_a_grid_matches_reference():
    """40 graphs x 8 source words: more (graph, word) items than the card
    has blocks, so a block takes several, across graph boundaries."""
    nbrs = np.stack([_nbr(130, [1, 2 + g % 40], 4) for g in range(40)])
    srcs = np.arange(130)
    got = bs.bfs_rows_batched(nbrs, srcs, 130, device="cpu").numpy()
    want = np.asarray(ref_bs.bfs_rows_batched(nbrs, srcs, 130))
    assert np.array_equal(got, want)


def test_sweep_counts_no_launch_on_the_cpu():
    nb, vm, F0, _, _ = bs.pack_batch(_nbr(64, [1, 5], 4)[None], np.arange(64))
    before = (bs.sweep.launches, dict(bs.sweep.shapes))
    bs.sweep(*(bs.as_words(a, CPU) for a in (nb, vm, F0)), 64)
    assert (bs.sweep.launches, dict(bs.sweep.shapes)) == before
