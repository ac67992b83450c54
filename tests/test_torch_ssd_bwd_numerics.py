"""The arithmetic of the bf16 SSD backward (``csrc/ssd_scan_bwd.cu``:
``ssd_bwd_col_bf16_kernel`` and ``ssd_bwd_row_bf16_kernel``, then
``ssd_intra_chunk_bwd_finish_kernel``) against the plain version and the
JAX package, and the wrapper's checks of the passes' domain.

The passes compute every product on the tensor cores from bf16 terms: S =
C Bᵀ from the bf16 operands; dW = gy Xᵀ, gB = B gstᵀ and so u from three
terms of the fp32 gy and gst (hi = bf16(v), mid = bf16(v − hi), lo =
bf16(v − hi − mid)); dx = Wᵀ gy (W and gy in two terms, the products
hi·hi, hi·mid and lo·hi), dB = dSᵀ C + w X gst and dC = dS B (dS from the
row pass's dW of two terms of gy) with W and dS in two terms; each product
of bf16 terms is exact and summed in fp32; cs, G's row and column sums, R
and dA in fp64.  A plain emulation of that arithmetic must meet the
tolerances ``chip_smoke.py`` phase 30 holds the kernels to (1e-2 of the
largest magnitude for dx, dB, dC, 1e-5 for ddt and dA) against
``ssd_intra_chunk_bwd_plain`` at mamba2-2.7b's and zamba2-2.7b's training
shapes cut to four heads, and the reference's own bf16 tolerance (3e-2)
against ``jax.grad`` of ``repro.models.ssm.ssd_chunked_ref``; one bf16
term misses ddt and dA.  The kernels themselves run only on the card
(phase 30)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked_ref as jssd_chunked_ref
from repro_torch.kernels import ssd_scan as ssd

NAMES = ("dx", "ddt", "dA", "dB", "dC")
TOL = {"dx": 1e-2, "ddt": 1e-5, "dA": 1e-5, "dB": 1e-2, "dC": 1e-2}
# bh, s, p, n, chunk, padding rows: mamba2-2.7b's and zamba2-2.7b's training
# shapes (b*h 640, s 1024, p 64, n 128 and 64, chunk 256) cut to four heads,
# then the bf16 domain's edges (p and n at 48 and 80, chunk 64 and 192,
# dt = 0 padding rows)
CASES = [(4, 1024, 64, 128, 256, 0), (4, 1024, 64, 64, 256, 0), (2, 512, 48, 80, 256, 7),
         (2, 384, 80, 48, 64, 0), (2, 576, 64, 128, 192, 5)]


def _inputs(seed, bh, s, p, n, chunk, pad=0):
    """bf16 x, B, C, fp32 dt (softplus of a normal, as the model makes it), A
    (−exp of a normal) and the output gradients gy, gst, drawn as
    ``chip_smoke.py`` phase 30 draws them; the last ``pad`` rows are
    ``ops.ssd_scan``'s padding (dt = 0, x = B = C = 0)."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.from_numpy(
        (scale * rng.normal(size=shape)).astype(np.float32))
    x, B, C = t(bh, s, p), t(bh, s, n, scale=0.5), t(bh, s, n, scale=0.5)
    dt = torch.nn.functional.softplus(t(bh, s))
    A = -torch.exp(t(bh, 1, scale=0.5))
    if pad:
        for v in (x, B, C, dt):
            v[:, s - pad:] = 0
    return (x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(), t(bh, s, p),
            t(bh, s // chunk, p, n))


def _split(v, terms):
    """v as a sum of ``terms`` bf16 values: bf16(v), then bf16 of what is left."""
    parts = []
    for _ in range(terms):
        parts.append(v.bfloat16().float())
        v = v - parts[-1]
    return parts


def _decay(cs):
    """L = exp(cs_i − cs_j) on the causal triangle as the two passes take it
    from cs (..., Q) in fp64: on a diagonal 64-row tile 2^ of the fp64
    difference times log2(e), rounded once to fp32; elsewhere 2^(a + b), a
    and b fp32 roundings of log2(e) times fp64 differences of one sign
    from a tile's edge: the column pass's (a = cs_i − cs_i0, b = cs_i0 −
    cs_j, i0 the first row of i's tile) and the row pass's (a = cs_i −
    cs_j1, b = −(cs_j − cs_j1), j1 the last row of j's tile)."""
    chunk = cs.shape[-1]
    log2e = 1.4426950408889634
    t = torch.arange(chunk)
    first, last = cs[..., t // 64 * 64], cs[..., t // 64 * 64 + 63]
    f32 = lambda v: (v * log2e).float()
    exact = f32(cs[..., :, None] - cs[..., None, :])
    col = f32(cs - first)[..., :, None] + f32(first[..., :, None] - cs[..., None, :])
    row = f32(cs[..., :, None] - last[..., None, :]) - f32(cs - last)[..., None, :]
    diag = (t[:, None] // 64) == (t[None, :] // 64)
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    return tuple(torch.exp2(torch.where(tril, torch.where(diag, exact, v), -torch.inf))
                 for v in (col, row))


def _kernel_numerics(x, dt, A, B, C, gy, gst, chunk, terms=3, w_terms=2):
    """The bf16 passes' arithmetic in PyTorch ops -> (dx, ddt, dA, dB, dC):
    gy and gst in ``terms`` bf16 terms where they feed G, u, ddt and dA; W,
    dS (and gy in dx and in the row pass's dW) in ``w_terms``; the product
    of two split operands keeps the pairs of terms whose indices sum below
    ``w_terms``; fp32 products of bf16 values (exact) summed in fp32; exp
    of (cs_i − cs_j) on the causal triangle only, as ``_decay`` takes it."""
    bh, s, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(bh, nc, chunk, p)
    Bf = B.float().reshape(bh, nc, chunk, n)
    Cf = C.float().reshape(bh, nc, chunk, n)
    dtc = dt.reshape(bh, nc, chunk)
    g = gy.reshape(bh, nc, chunk, p)
    a = A.double().reshape(bh, 1, 1)
    cs = torch.cumsum(dtc.double() * a, dim=-1)
    L, L_row = _decay(cs)
    Ldt = L * dtc[..., None, :]
    S = torch.matmul(Cf, Bf.transpose(-1, -2))
    dW = sum(torch.matmul(t, xf.transpose(-1, -2)) for t in _split(g, terms))
    W, dS = S * Ldt, dW * Ldt
    G = (dW * W).double()
    direct = (dW * (S * L)).sum(-2)  # ddt's direct term
    wt = w_terms
    g2, Wp = _split(g, wt), _split(W, wt)
    dx = sum(torch.matmul(Wp[k].transpose(-1, -2), g2[m]) for k in range(wt) for m in range(wt)
             if k + m < wt)
    dB = sum(torch.matmul(t.transpose(-1, -2), Cf) for t in _split(dS, wt))
    dS_row = sum(torch.matmul(t, xf.transpose(-1, -2)) for t in g2) * (L_row * dtc[..., None, :])
    dC = sum(torch.matmul(t, Bf) for t in _split(dS_row, wt))
    gB = sum(torch.matmul(Bf, t.transpose(-1, -2)) for t in _split(gst, terms))
    XG = sum(torch.matmul(xf, t) for t in _split(gst, wt))
    decay = torch.exp((cs[..., -1:] - cs).float())
    w = decay * dtc
    u = (xf * gB).sum(-1)
    dx = dx + w[..., None] * gB
    dB = dB + w[..., None] * XG
    wu = (w * u).double()
    dcs = G.sum(-1) - G.sum(-2) - wu
    dcs[..., -1] += wu.sum(-1)
    R = dcs.flip(-1).cumsum(-1).flip(-1)
    ddt = (direct + decay * u).double() + a * R
    dA = (dtc.double() * R).sum((-1, -2)).reshape(bh, 1)
    return (dx.reshape(bh, s, p).to(x.dtype), ddt.reshape(bh, s).float(), dA.float(),
            dB.reshape(bh, s, n).to(B.dtype), dC.reshape(bh, s, n).to(C.dtype))


def _rel_errs(got, want):
    """Largest difference of each gradient over its largest magnitude."""
    return {name: float((g.double() - w.double()).abs().max() / w.double().abs().max())
            for name, g, w in zip(NAMES, got, want)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_bwd_numerics_meet_smoke_tolerances(case):
    bh, s, p, n, chunk, pad = case
    args = _inputs(sum(case), bh, s, p, n, chunk, pad)
    got = _kernel_numerics(*args, chunk)
    errs = _rel_errs(got, ssd.ssd_intra_chunk_bwd_plain(*args, chunk))
    assert all(errs[k] <= TOL[k] for k in NAMES), errs
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    if pad:  # no gradient reaches dx, dB or dC of a padding row but through dt
        assert not got[0][:, s - pad:].any() and not got[3][:, s - pad:].any()


def test_one_bf16_term_misses_ddt_and_da():
    """Why gy and gst are split into three terms: dcs sums to 0 over a
    chunk, so ddt and dA are differences of large sums, and one bf16
    rounding of each fp32 operand misses their 1e-5 at mamba2-2.7b's shape
    by two orders of magnitude (dx, dB and dC still pass: they are rounded
    to bf16 anyway); two terms pass with a few times of margin, three with
    tens."""
    bh, s, p, n, chunk, _ = CASES[0]
    args = _inputs(sum(CASES[0]), bh, s, p, n, chunk)
    want = ssd.ssd_intra_chunk_bwd_plain(*args, chunk)
    one = _rel_errs(_kernel_numerics(*args, chunk, terms=1, w_terms=1), want)
    assert min(one["ddt"], one["dA"]) > 1e-4, one
    assert max(one[k] for k in ("dx", "dB", "dC")) <= 1e-2, one
    two = _rel_errs(_kernel_numerics(*args, chunk, terms=2), want)
    three = _rel_errs(_kernel_numerics(*args, chunk), want)
    assert max(two["ddt"], two["dA"]) <= 1e-5, two
    assert 10 * max(three["ddt"], three["dA"]) <= max(two["ddt"], two["dA"]), (two, three)


def _jax_grads(args, chunk):
    """``jax.grad`` of sum(y gy) + sum(H gst) through the reference's
    ``ssd_chunked_ref`` with each chunk a sequence of its own (batch = the
    chunks, heads = bh, no initial state), where y is the intra-chunk term
    and H the chunk state, on the same bf16 x, B, C -> (dx, ddt, dA, dB, dC)
    in the kernel's layout."""
    x, dt, A, B, C, gy, gst = args
    bh, s, p = x.shape
    nc = s // chunk
    seqs = lambda v: jnp.asarray(
        v.float().reshape(bh, nc, chunk, *v.shape[2:]).transpose(0, 1).transpose(1, 2).numpy())
    lay = lambda g: torch.from_numpy(np.array(g, np.float32)).transpose(1, 2).transpose(
        0, 1).reshape(bh, s, *g.shape[3:])
    gy_j, gst_j = seqs(gy), jnp.asarray(gst.transpose(0, 1).numpy())

    def f(x, dt, A, B, C):
        y, H = jssd_chunked_ref(x, dt, A, B, C, chunk)
        return jnp.sum(y.astype(jnp.float32) * gy_j) + jnp.sum(H * gst_j)

    bf = lambda v: seqs(v).astype(jnp.bfloat16)
    dts = seqs(dt[..., None])[..., 0]
    g = jax.grad(f, argnums=(0, 1, 2, 3, 4))(bf(x), dts, jnp.asarray(A[:, 0].numpy()), bf(B),
                                             bf(C))
    return (lay(g[0]), lay(np.asarray(g[1], np.float32)[..., None])[..., 0],
            torch.from_numpy(np.array(g[2], np.float32)).reshape(bh, 1), lay(g[3]), lay(g[4]))


@pytest.mark.parametrize("case", [(2, 256, 64, 128, 64), (2, 192, 48, 32, 64)],
                         ids=lambda c: "-".join(map(str, c)))
def test_bf16_bwd_numerics_match_jax_grad(case):
    """At chunk 64, where the reference's fp32 gradient is finite (exp(cs_i −
    cs_j) above the causal triangle stays below fp32's overflow), within the
    reference's own bf16 tolerance (3e-2 of each gradient's largest
    magnitude, ``tests/test_torch_ssd_bwd.py``)."""
    bh, s, p, n, chunk = case
    args = _inputs(7 + sum(case), bh, s, p, n, chunk)
    want = _jax_grads(args, chunk)
    assert all(bool(torch.isfinite(w).all()) for w in want)
    errs = _rel_errs(_kernel_numerics(*args, chunk), want)
    assert max(errs.values()) <= 3e-2, errs


# the bf16 training shapes: mamba2-2.7b and zamba2-2.7b (b*h, s, p, n, chunk)
TRAIN_SHAPES = [(640, 1024, 64, 128, 256), (640, 1024, 64, 64, 256)]


def _operands(bh, s, p, n, chunk, dtype=torch.bfloat16, shift=0):
    """Zero operands of a shape (nothing is computed); ``shift`` moves x and
    gy 2 and 4 bytes past an aligned start."""
    mk = lambda shape, dt: (torch.zeros(int(np.prod(shape)) + 8, dtype=dt)[shift:][
        :int(np.prod(shape))].view(shape))
    return (mk((bh, s, p), dtype), torch.zeros(bh, s), torch.zeros(bh, s, n, dtype=dtype),
            torch.zeros(bh, s, n, dtype=dtype), mk((bh, s, p), torch.float32),
            torch.zeros(bh, s // chunk, p, n))


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_bwd_domain_takes_the_training_shapes(shape):
    *dims, chunk = shape
    ops = _operands(*shape)
    ssd.check_bf16_bwd_domain(*ops, chunk)
    assert ssd.bwd_kernel(*ops, chunk) == "ssd_bwd_col_bf16_kernel"
    # two blocks of the column pass (and of the row pass) fit an SM's 228 KB
    assert all(2 * (b + 1024) <= 233472 for b in ssd.bf16_bwd_smem_bytes(chunk, *dims[2:]))


def test_bf16_bwd_smem_is_pinned():
    """mamba2-2.7b's column pass: B_j and X_j (12 slabs of 2 KB), dt, cs and
    its fp32 offsets (4 KB), two stages of C_i and gy_i's three terms (20
    slabs each), 4 KB of column sums, the mbarriers and the alignment
    slack; its row pass: gy_i's two terms (8 slabs), the same 4 KB, two
    stages of B_j and X_j (12 slabs each)."""
    assert ssd.bf16_bwd_smem_bytes(256, 64, 128) == (
        12 * 2048 + 4096 + 2 * 20 * 2048 + 4096 + 64 + 256,
        8 * 2048 + 4096 + 2 * 12 * 2048 + 64 + 256)


@pytest.mark.parametrize("shape,dtype,shift,match", [
    ((2, 256, 8, 16, 16), torch.bfloat16, 0, "multiple of 64"),
    ((2, 160, 16, 16, 80), torch.bfloat16, 0, "multiple of 64"),
    ((2, 256, 8, 16, 64), torch.bfloat16, 0, "p a multiple of 16"),
    ((2, 256, 16, 144, 64), torch.bfloat16, 0, "n a multiple of 16 up to 128"),
    ((2, 256, 136, 16, 64), torch.bfloat16, 0, "p a multiple of 16 up to 128"),
    ((1, 16384, 128, 128, 16384), torch.bfloat16, 0, "shared memory"),
    ((2, 256, 64, 128, 256), torch.float32, 0, "takes bf16"),
    ((2, 256, 64, 128, 256), torch.bfloat16, 1, "x must start on a 16-byte boundary")])
def test_bf16_bwd_domain_refuses(shape, dtype, shift, match):
    """Outside the bf16 passes' domain the check names why, device-free, and
    the wrapper takes the CUDA-core kernel by shape before any launch."""
    chunk = shape[-1]
    ops = _operands(*shape, dtype=dtype, shift=shift)
    with pytest.raises(ValueError, match=match):
        ssd.check_bf16_bwd_domain(*ops, chunk)
    assert ssd.bwd_kernel(*ops, chunk) == "ssd_intra_chunk_bwd_kernel"


def test_bf16_bwd_domain_refuses_a_misaligned_gradient():
    x, dt, B, C, _, gst = _operands(2, 256, 64, 128, 256)
    gy = torch.zeros(2 * 256 * 64 + 1)[1:].view(2, 256, 64)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="gy must start on a 16-byte boundary"):
        ssd.check_bf16_bwd_domain(x, dt, B, C, gy, gst, 256)


def test_bf16_bwd_runs_plain_on_the_cpu():
    """On a CPU tensor the wrapper runs ``ssd_intra_chunk_bwd_plain`` and
    counts no launch of either kernel."""
    args = _inputs(1, 2, 256, 64, 64, 64)
    n, n16 = ssd.ssd_intra_chunk_bwd.launches, ssd.ssd_intra_chunk_bwd.bf16_launches
    got = ssd.ssd_intra_chunk_bwd(*args, 64)
    want = ssd.ssd_intra_chunk_bwd_plain(*args, 64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (ssd.ssd_intra_chunk_bwd.launches, ssd.ssd_intra_chunk_bwd.bf16_launches) == (n, n16)


def test_bwd_layout_probe_runs_on_the_card_only():
    bf = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_bwd_wgmma_layout_probe(bf(64, 128), bf(64, 128), bf(64, 64), torch.zeros(64, 64),
                                       torch.zeros(64, 128), torch.zeros(64, 64),
                                       torch.zeros(64, 64))
