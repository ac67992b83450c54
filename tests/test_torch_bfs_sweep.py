"""The port's packed BFS sweep and min-plus patch (repro_torch.kernels.bfs_sweep)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do; the
port's wrappers run their plain PyTorch versions, because the tensors lie on
the CPU.  Every comparison is exact equality: all values are integer hop
counts.
"""
import numpy as np
import jax
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.core.graphs import circulant as ref_circulant
from repro.kernels import bfs_sweep as ref_bs
from repro_torch.kernels import bfs_sweep as bs

CPU = torch.device("cpu")


def _nbr(n, offsets, kmax=None):
    return ref_metrics._nbr_table(ref_circulant(n, offsets).adjacency(), kmax)


def _random_patches(rng, b, n, s):
    """Per-proposal added edge lists (some None), as the polish packs them."""
    patches = []
    for r in range(b):
        if r % 3 == 2:
            patches.append(None)
            continue
        m = int(rng.integers(1, 5))
        edges = set()
        while len(edges) < m:
            u, v = (int(x) for x in rng.integers(0, n, 2))
            if u != v:
                edges.add((min(u, v), max(u, v)))
        patches.append(sorted(edges))
    return patches


def test_packers_equal_reference_byte_for_byte():
    rng = np.random.default_rng(0)
    assert (bs.WORD, bs.BLOCK_WORDS, int(bs.PATCH_INF)) == \
        (ref_bs.WORD, ref_bs.BLOCK_WORDS, int(ref_bs.PATCH_INF))
    nbr = _nbr(70, [1, 5, 35])  # n/2 offset: ragged degrees, -1 padding
    for a, b in zip(bs.pack_nbr(nbr), ref_bs.pack_nbr(nbr)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    srcs = rng.permutation(70)[:45]
    a, b = bs.pack_frontier(70, srcs, 2), ref_bs.pack_frontier(70, srcs, 2)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    nbrs = np.stack([nbr, _nbr(70, [2, 9, 35])])
    for bw in (1, 2, 4):
        got, want = bs.pack_batch(nbrs, srcs, bw), ref_bs.pack_batch(nbrs, srcs, bw)
        assert got[3:] == want[3:]
        assert all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
                   for x, y in zip(got[:3], want[:3]))
    lists = [np.sort(rng.choice(20, size=int(rng.integers(0, 20)), replace=False))
             for _ in range(4)]
    got = bs.pack_delta_batch(np.stack([nbr] * 4), lists, 20)
    want = ref_bs.pack_delta_batch(np.stack([nbr] * 4), lists, 20)
    assert got[4:] == want[4:]
    assert all(x.dtype == y.dtype and x.tobytes() == y.tobytes()
               for x, y in zip(got[:4], want[:4]))
    patches = _random_patches(rng, 5, 70, 14)
    for x, y in zip(bs.pack_patch(patches, 14), ref_bs.pack_patch(patches, 14)):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for x in (0, 1, 2, 3, 5, 17, 64, 65):
        assert bs._pow2(x) == ref_bs._pow2(x)
    for s in (1, 12, 128, 130, 512, 2048):
        assert bs._row_block(s) == ref_bs._row_block(s)


# (n, offsets, sources, block_words): tests/test_kernels.py's cases, a
# disconnected graph (sentinel rows), empty sources, block widths 1/2/4 and
# sources whose lane is bit 31 of a word
SWEEP_CASES = [
    (96, [1, 7], np.arange(96), 4),
    (130, [2, 9, 31], np.arange(37), 4),
    (64, [1, 5], np.arange(64), 4),
    (60, [2, 4], np.arange(60), 4),  # even offsets only: two components
    (48, [1, 7], np.arange(0), 4),
    (100, [1, 9], np.arange(100)[::-1], 1),
    (100, [1, 9], np.arange(77), 2),
    (90, [3, 10, 45], np.random.default_rng(1).permutation(90)[:64], 4),
    (40, [1, 3], np.array([31, 0, 39]), 1),
]


@pytest.mark.parametrize("n,offs,srcs,bw", SWEEP_CASES)
def test_bfs_rows_matches_pallas_and_bitset(n, offs, srcs, bw):
    nbr = _nbr(n, offs)
    got = bs.bfs_rows(nbr, srcs, n, device="cpu", block_words=bw)
    want = ref_bs.bfs_rows(nbr, srcs, n, block_words=bw)
    assert got.dtype == np.int32 and got.shape == (len(srcs), n)
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref_metrics.bitset_bfs_rows(nbr, srcs, n))
    if offs == [2, 4]:
        assert (got == n).any()  # the sentinel path is exercised


def test_sweep_bit31_and_batched_stack():
    """A source in lane 31 of a word (int32 >> sign-extends there) and a
    stacked batch: each graph priced exactly as the reference's batched
    Pallas sweep prices it."""
    n = 70
    nbrs = np.stack([_nbr(n, offs, 5) for offs in ([1, 7], [1, 11], [2, 35])])
    srcs = np.arange(33)[::-1]  # lane 31 holds vertex 1, lane 32 vertex 0
    nb, vm, F0, _, _ = bs.pack_batch(nbrs, srcs)
    assert (F0.view(np.int32) < 0).any()  # bit 31 set: negative as int32
    got = bs.sweep(*(bs.as_words(a, CPU) for a in (nb, vm, F0)), n)
    want = np.asarray(ref_bs.bfs_rows_batched(nbrs, srcs, n))
    assert np.array_equal(got[:, : len(srcs)].numpy(), want)
    assert np.array_equal(
        bs.bfs_rows_batched(nbrs, srcs, n, device="cpu").numpy(), want)


def test_patch_prologue_and_apply_match_reference():
    rng = np.random.default_rng(2)
    b, s, n = 6, 12, 48
    new = rng.integers(0, n + 1, size=(b, s, n)).astype(np.int32)
    new[1, 3, 7] = n  # a sentinel entry
    patch = ref_bs.pack_patch(_random_patches(rng, b, n, s), s)
    mmax = patch[2].shape[1]
    tmp_r, crows_r = jax.vmap(ref_bs.patch_prologue)(new, *patch)
    want = ref_bs._pallas_patch(b, s, n, mmax, interpret=True)(new, tmp_r, crows_r)
    tmp, crows = bs.patch_prologue(torch.from_numpy(new),
                                   *(torch.from_numpy(a) for a in patch))
    assert np.array_equal(tmp.numpy(), np.asarray(tmp_r))
    assert np.array_equal(crows.numpy(), np.asarray(crows_r))
    got = bs.patch_apply(torch.from_numpy(new), tmp, crows)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), new)  # the patch did something


def test_wrappers_validate_inputs():
    nb = torch.zeros((1, 8, 2), dtype=torch.int32)
    F0 = torch.zeros((1, 8, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        bs.sweep(nb.long(), nb, F0, 8)
    with pytest.raises(ValueError, match="shape"):
        bs.sweep(nb, nb[:, :4], F0, 8)
    with pytest.raises(ValueError, match="contiguous"):
        bs.sweep(nb, torch.zeros((1, 2, 8), dtype=torch.int32).transpose(1, 2), F0, 8)
    d = torch.zeros((1, 4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        bs.patch_apply(d, torch.zeros((1, 4, 3), dtype=torch.int32),
                       torch.zeros((1, 2, 8), dtype=torch.int32))
    # a device that is neither CUDA nor CPU raises; nothing falls back
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bs.sweep(nb.to(meta), nb.to(meta), F0.to(meta), 8)
