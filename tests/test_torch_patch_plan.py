"""The instantiation plan of ``minplus_patch_kernel`` (repro_torch.kernels.bfs_sweep.
patch_plan) and the shapes at the edges of its instantiations, run through the
port's ``patch_apply`` on the CPU against the JAX package.

The plan is pure Python, so its choice and its shared-memory bytes are held
here; the kernel itself runs only on the card (``chip_smoke.py`` phase 4 runs
these cases there).  On the CPU ``patch_apply`` runs its plain version, which
must equal the reference's ``patch_apply_ref`` and its Pallas kernel (in
interpret mode) exactly on every case.  Inputs are made with numpy from a
seed.
"""
import numpy as np
import jax
import pytest
import torch

from repro.core import metrics as ref_metrics
from repro.kernels import bfs_sweep as ref_bs
from repro_torch.core.graphs import circulant
from repro_torch.core.known_optimal import KNOWN_CIRCULANT_OFFSETS
from repro_torch.core.search import _circulant_orbits, _draw_orbit_swap, _PolishChain
from repro_torch.kernels import bfs_sweep as bs

INF = int(bs.PATCH_INF)
TILE = bs.PatchPlan("tile", 0, 1024, 128, 32, 0, (32 * 32 + 32 * 128) * 4)


def _stream(mmax, warps=8, rows=8):
    strip = 128 * warps
    stage = rows * strip * 4 + (rows * mmax * 4 if mmax % 4 == 0 else 0) + 16
    stages = 100 * 1024 // stage
    return bs.PatchPlan("stream", mmax, 32 * (warps + 1), strip, rows, stages, stages * stage)


@pytest.mark.parametrize("shape,aligned,want", [
    ((32, 2048, 8192, 16), True, bs.PatchPlan("stream", 16, 288, 1024, 8, 3, 3 * 33296)),
    ((32, 2048, 8192, 8), True, bs.PatchPlan("stream", 8, 288, 1024, 8, 3, 3 * 33040)),
    ((32, 2048, 16384, 16), True, _stream(16)),
    ((2, 40, 130, 8), True, TILE),
    ((2, 50, 1000, 16), True, _stream(16)),
    ((3, 96, 2048, 1), True, bs.PatchPlan("stream", 1, 288, 1024, 8, 3, 3 * 32784)),
    ((3, 96, 2048, 64), True, TILE),
    ((3, 96, 2048, 3), True, TILE),
    ((1, 4, 256, 16), True, bs.PatchPlan("stream", 16, 96, 256, 8, 11, 11 * 8720)),
    ((32, 2048, 8192, 16), False, TILE),
])
def test_patch_plan_choice_and_bytes(shape, aligned, want):
    """The polish's (32, 2048, 8192, 16) streams 8-row stages of 1024-column
    strips, three stages (99888 B, so two blocks share an SM's 228 KB);
    n % 4 != 0, endpoint counts that are no template and unaligned tensors
    take the tile instantiation."""
    assert bs.patch_plan(*shape, aligned=aligned) == want


def test_patch_plan_fits_and_covers_every_shape():
    for n in (1, 4, 100, 128, 129, 130, 256, 1000, 1024, 1028, 3000, 8192, 16384):
        for mmax in (0, 1, 2, 3, 4, 8, 16, 17, 32, 64):
            for b, s in ((1, 1), (3, 7), (32, 2048)):
                plan = bs.patch_plan(b, s, n, mmax)
                assert plan.smem_bytes <= bs.SMEM_BYTES
                stream = mmax in (1, 2, 4, 8, 16, 32) and n % 4 == 0
                assert (plan.kind == "stream") == stream
                if not stream:
                    assert plan == TILE
                    continue
                assert plan.mmax == mmax and plan.threads == 32 + plan.strip // 4
                assert plan.strip % 128 == 0 and plan.strip <= 1024
                # one strip covers n, or the strip is as wide as it goes
                assert plan.strip >= n or plan.strip == 1024
                assert plan.strip - n < 128  # no warp without a column
                assert 1 <= plan.stages <= 32 and plan.rows == 8
                assert plan.smem_bytes == bs._patch_smem(mmax, plan.strip, plan.rows,
                                                         plan.stages)
                # two blocks an SM (228 KB, 1 KB reserved a block)
                assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024


@pytest.mark.parametrize("shape", [
    (0, 4, 8, 4), (2, 0, 8, 4), (2, 4, 0, 4), (2, 4, 8, -1),
    (65536, 4, 130, 8),            # tile: more proposals than the grid holds
    (2, 65535 * 32 + 1, 130, 8),   # tile: more row tiles than the grid holds
    (65536, 32768, 8, 16),         # 2^31 stream units: the tile, too wide
])
def test_patch_plan_refuses(shape):
    with pytest.raises(ValueError, match="minplus_patch_kernel"):
        bs.patch_plan(*shape)


def _inputs(rng, b, s, n, mmax, inf_share=0.25):
    dist = rng.integers(0, 16, (b, s, n), dtype=np.int32)
    tmp = rng.integers(1, 24, (b, s, mmax), dtype=np.int32)
    tmp[rng.random(tmp.shape) < inf_share] = INF
    crows = rng.integers(0, 16, (b, mmax, n), dtype=np.int32)
    return dist, tmp, crows


def _all_inf(rng):
    dist, tmp, crows = _inputs(rng, 2, 16, 512, 16)
    tmp[:] = INF
    return dist, tmp, crows


def _largest_sums(rng):
    n = 256
    return (np.full((2, 8, n), n, np.int32), np.full((2, 8, 16), 2 * INF, np.int32),
            np.full((2, 16, n), n, np.int32))


# (label, inputs, the instantiation the card runs, whether dist stays as it is):
# chip_smoke.py phase 4's edge cases, at sizes the interpreter takes
EDGE_CASES = [
    ("mmax=1", lambda r: _inputs(r, 3, 12, 256, 1), "stream", False),
    ("mmax=2", lambda r: _inputs(r, 3, 12, 256, 2), "stream", False),
    ("mmax=3", lambda r: _inputs(r, 3, 12, 256, 3), "tile", False),
    ("mmax=4", lambda r: _inputs(r, 3, 12, 256, 4), "stream", False),
    ("mmax=32", lambda r: _inputs(r, 2, 12, 256, 32), "stream", False),
    ("mmax=64", lambda r: _inputs(r, 2, 12, 256, 64), "tile", False),
    ("n=130", lambda r: _inputs(r, 2, 8, 130, 8), "tile", False),
    ("n=1001", lambda r: _inputs(r, 2, 8, 1001, 8), "tile", False),
    ("n=1000, a strip cut short", lambda r: _inputs(r, 2, 8, 1000, 16), "stream", False),
    ("n=3000, a strip cut short", lambda r: _inputs(r, 2, 8, 3000, 16), "stream", False),
    ("s=1", lambda r: _inputs(r, 3, 1, 1024, 16), "stream", False),
    ("s=7", lambda r: _inputs(r, 3, 7, 1024, 16), "stream", False),
    ("b=1", lambda r: _inputs(r, 1, 24, 512, 16), "stream", False),
    ("tmp all PATCH_INF", _all_inf, "stream", True),
    ("sentinel dist, tmp + crows = 2 PATCH_INF + n", _largest_sums, "stream", True),
]


@pytest.mark.parametrize("label,make,kind,unchanged", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_patch_edge_cases_match_reference(label, make, kind, unchanged):
    dist, tmp, crows = make(np.random.default_rng(7))
    b, s, n = dist.shape
    mmax = crows.shape[1]
    assert bs.patch_plan(b, s, n, mmax).kind == kind
    got = bs.patch_apply(*(torch.from_numpy(a) for a in (dist, tmp, crows))).numpy()
    want = np.asarray(ref_bs.patch_apply_ref(dist, tmp, crows))
    assert np.array_equal(got, want)
    pallas = ref_bs._pallas_patch(b, s, n, mmax, interpret=True)(dist, tmp, crows)
    assert np.array_equal(got, np.asarray(pallas))
    assert np.array_equal(got, dist) == unchanged


def _orbit_swaps(n, k, count, fold=4, seed=0):
    """(post-removal tables, swapped tables, added edge lists) of ``count``
    orbit swaps of the pinned circulant, drawn as a polish iteration draws
    them."""
    s = n // fold
    offsets = KNOWN_CIRCULANT_OFFSETS[(n, k)]
    ring = {(i, (i + 1) % n) for i in range(n - 1)} | {(0, n - 1)}
    rng = np.random.default_rng(seed)
    ch = _PolishChain(rng, sorted(_circulant_orbits(n, s, offsets), key=sorted),
                      circulant(n, offsets).adjacency(), 0.05)
    post, full, added = [], [], []
    while len(added) < count:
        mv = _draw_orbit_swap(rng, ch.orb_list, ch.chord_edges, ring, n, s, fold)
        if mv is None:
            continue
        work = mv[5] | mv[4]
        removed = sorted(ch.chord_edges - work)
        added.append(sorted(work - ch.chord_edges))
        post.append(ch.trial_nbr(removed, ()))
        full.append(ch.trial_nbr(removed, added[-1]))
    return np.stack(post), np.stack(full), added


def test_polish_patches_have_four_fold_endpoints():
    """Two orbits of fold = 4 edges a proposal: pack_patch pads the polish's
    patches to mmax = 16, the shape phase 4 times, in both packages."""
    n, s = 512, 128
    _, _, added = _orbit_swaps(n, 8, 8)
    assert all(len(e) <= 8 for e in added)
    assert max(len({x for e in edges for x in e}) for edges in added) > 8
    for pack in (bs.pack_patch, ref_bs.pack_patch):
        assert pack(added, s)[2].shape == (8, 16)


def test_patch_of_real_orbit_swaps_gives_swapped_rows():
    """Priced states: the post-removal rows of orbit swaps of the pinned
    (512, 8) circulant, patched with their added edges through
    patch_prologue, are the swapped graphs' rows, and equal the reference's
    prologue and Pallas patch."""
    n, k, s = 512, 8, 128
    post, full, added = _orbit_swaps(n, k, 4)
    rows = lambda tables: np.stack([ref_metrics.bitset_bfs_rows(t, np.arange(s), n)
                                    for t in tables]).astype(np.int32)
    state = rows(post)
    patch = bs.pack_patch(added, s)
    tmp, crows = bs.patch_prologue(torch.from_numpy(state), *map(torch.from_numpy, patch))
    assert crows.shape[1] == 16
    got = bs.patch_apply(torch.from_numpy(state), tmp, crows).numpy()
    assert np.array_equal(got, rows(full))
    assert not np.array_equal(got, state)
    tmp_r, crows_r = jax.vmap(ref_bs.patch_prologue)(state, *patch)
    want = ref_bs._pallas_patch(4, s, n, 16, interpret=True)(state, tmp_r, crows_r)
    assert np.array_equal(got, np.asarray(want))


def test_patch_apply_counts_no_launch_on_the_cpu():
    dist, tmp, crows = (torch.from_numpy(a) for a in _inputs(np.random.default_rng(8),
                                                            2, 8, 256, 16))
    before = (bs.patch_apply.launches, dict(bs.patch_apply.shapes))
    bs.patch_apply(dist, tmp, crows)
    assert (bs.patch_apply.launches, dict(bs.patch_apply.shapes)) == before
