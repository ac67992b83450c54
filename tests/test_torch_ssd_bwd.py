"""The gradient of the SSD intra-chunk term on the CPU:
``ssd_scan.ssd_intra_chunk_bwd_plain`` (the function of the backward
kernels of ``csrc/ssd_scan_bwd.cu``) against autograd through the plain
forward in float64, and ``ops.ssd_scan``'s gradients through the
``torch.autograd.Function`` against ``jax.grad`` of the JAX package's
``repro.models.ssm.ssd_chunked_ref``: 5e-5 in fp32 and 3e-2 in bf16,
relative to each gradient's largest magnitude, as
``tests/test_torch_flash_attention_bwd.py`` states its own.  At the
configs' chunk of 256 with mamba2's dt and A, the reference's fp32 gradient
of dt and A is NaN (exp(cs_i − cs_j) overflows above the causal triangle
and its masked gradient is 0 · inf); the port's is finite and equal to
float64 autograd.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` phase 30)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked_ref as jssd_chunked_ref
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd

TOL = {"float32": 5e-5, "bfloat16": 3e-2}
NAMES = ("dx", "ddt", "dA", "dB", "dC")

# tests/test_torch_ssd_scan.py's SSD_CASES in the kernel's layout (bh = b h,
# s padded to the chunk), a case with p != n the other way round, and the
# reduced configs' p 8, n 16 at a chunk of 16: bh, s, p, n, chunk
PLAIN_CASES = [(8, 64, 8, 16, 16), (2, 96, 64, 128, 32), (8, 128, 8, 16, 32),
               (2, 256, 16, 32, 256), (3, 96, 24, 8, 48), (4, 48, 8, 16, 16)]


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def _kernel_inputs(bh, s, p, n, chunk, seed, pad=0, dtype=torch.float32):
    """x, dt, A, B, C of the kernel's layout, drawn as the model draws dt
    (softplus) and A (−exp), and the output gradients gy, gst (float64).
    The last ``pad`` rows are ops.ssd_scan's padding: dt = 0, x = B = C = 0."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, scale=1.0: torch.from_numpy(scale * rng.normal(size=shape))
    x, B, C = t(bh, s, p), t(bh, s, n, scale=0.5), t(bh, s, n, scale=0.5)
    dt = torch.nn.functional.softplus(t(bh, s))
    A = -torch.exp(t(bh, 1, scale=0.5))
    if pad:
        for v in (x, B, C, dt):
            v[:, s - pad:] = 0
    gy, gst = t(bh, s, p), t(bh, s // chunk, p, n)
    ins = [v.to(dtype) if v.dim() == 3 else v for v in (x, dt, A, B, C)]
    return [v.double() for v in ins], gy, gst


def _autograd(ins, gy, gst, chunk):
    """Gradients of sum(y gy) + sum(states gst) through the plain forward."""
    args = [v.clone().requires_grad_() for v in ins]
    y, st = ssd.ssd_intra_chunk_plain(*args, chunk)
    return torch.autograd.grad((y * gy).sum() + (st * gst).sum(), args)


@pytest.mark.parametrize("pad", [0, 5])
@pytest.mark.parametrize("case", PLAIN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_plain_matches_autograd(case, pad):
    """The plain backward in float64 equals autograd through the plain
    forward in float64 to rounding; in fp32 (the kernels' arithmetic) it is
    within the fp32 tolerance of it, also with dt = 0 padding rows."""
    bh, s, p, n, chunk = case
    ins, gy, gst = _kernel_inputs(bh, s, p, n, chunk, seed=sum(case) + pad, pad=pad)
    want = _autograd(ins, gy, gst, chunk)
    exact = ssd.ssd_intra_chunk_bwd_plain(*ins, gy, gst, chunk)
    f32 = [v.float() for v in ins]
    got = ssd.ssd_intra_chunk_bwd_plain(*f32, gy.float(), gst.float(), chunk)
    for name, e, g, w in zip(NAMES, exact, got, want):
        assert _rel(e, w) <= 1e-10, (name, _rel(e, w))
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel(g, w) <= TOL["float32"], (name, _rel(g, w))
    if pad:  # no gradient reaches dx, dB or dC of a padding row but through dt
        assert not got[0][:, s - pad:].any() and not got[3][:, s - pad:].any()


def _jax_grads(arrs, gy, gH, chunk, dtype):
    def f(x, dt, A, B, C, h0):
        y, H = jssd_chunked_ref(x, dt, A, B, C, chunk, init_state=h0)
        return jnp.sum(y.astype(jnp.float32) * gy) + jnp.sum(H * gH)

    jd = getattr(jnp, dtype)
    args = [jnp.asarray(arrs[k], jd if k in "xBC" else jnp.float32)
            for k in ("x", "dt", "A", "B", "C", "h0")]
    return [np.asarray(g, np.float32) for g in jax.grad(f, argnums=tuple(range(6)))(*args)]


# b, s, h, p, n, chunk: s not a multiple of the chunk in the last three
SCAN_CASES = [(2, 64, 4, 8, 16, 16), (1, 100, 2, 16, 32, 32), (2, 50, 3, 8, 16, 16),
              (1, 75, 2, 24, 8, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_scan_gradients_match_jax_grad(case, dtype, monkeypatch):
    """``ops.ssd_scan`` with an initial state, through ``_SsdIntraChunk`` on
    the CPU (its backward runs ``ssd_intra_chunk_bwd_plain`` once, and no
    kernel launches), against ``jax.grad`` of the reference's chunked scan
    on the same rounded inputs."""
    b, s, h, p, n, chunk = case
    rng = np.random.default_rng(s + p)
    arrs = dict(x=rng.normal(size=(b, s, h, p)), dt=np.abs(rng.normal(size=(b, s, h))) * 0.5,
                A=-np.abs(rng.normal(size=(h,))), B=rng.normal(size=(b, s, h, n)),
                C=rng.normal(size=(b, s, h, n)), h0=rng.normal(size=(b, h, p, n)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    for k in "xBC":  # the same rounded inputs on both sides
        arrs[k] = np.array(jnp.asarray(arrs[k], getattr(jnp, dtype)), np.float32)
    gy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    gH = rng.normal(size=(b, h, p, n)).astype(np.float32)
    want = _jax_grads(arrs, gy, gH, chunk, dtype)

    calls = []
    plain = ssd.ssd_intra_chunk_bwd_plain
    monkeypatch.setattr(ssd, "ssd_intra_chunk_bwd_plain",
                        lambda *a: calls.append(1) or plain(*a))
    td = getattr(torch, dtype)
    args = [torch.from_numpy(arrs[k]).to(td if k in "xBC" else torch.float32).requires_grad_()
            for k in ("x", "dt", "A", "B", "C", "h0")]
    launches = ssd.ssd_intra_chunk_bwd.launches
    y, H = ops.ssd_scan(*args[:5], chunk=chunk, init_state=args[5])
    loss = (y * torch.from_numpy(gy)).sum() + (H * torch.from_numpy(gH)).sum()
    grads = torch.autograd.grad(loss, args)
    assert calls == [1] and ssd.ssd_intra_chunk_bwd.launches == launches
    for name, g, w, a in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), grads, want, args):
        assert g.dtype == a.dtype and g.shape == a.shape
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= TOL[dtype], (name, err)


def test_chunk_256_is_finite_where_the_reference_is_nan():
    """mamba2's setting at its chunk of 256 (b 1, s 256, h 2, p = n = 8; dt =
    softplus of a normal, A = −1, its init A_log = 0): cs falls below −88.7
    within the chunk, so exp(cs_i − cs_j) overflows fp32 above the causal
    triangle.  The reference's fp32 ``jax.grad`` then carries NaN in dt and
    A; the port's plain backward, which takes exp on the triangle only, is
    finite and equals float64 autograd through the plain forward within the
    fp32 tolerance; so are ``ops.ssd_scan``'s gradients through the
    Function."""
    b, s, h, p, n, chunk = 1, 256, 2, 8, 8, 256
    rng = np.random.default_rng(0)
    x, B, C = (rng.normal(size=(b, s, h, d)).astype(np.float32) for d in (p, n, n))
    dt = np.array(jax.nn.softplus(rng.normal(size=(b, s, h)).astype(np.float32)))
    A = -np.ones(h, np.float32)
    gy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    assert (np.cumsum(dt * A, axis=1) < -88.8).any()  # exp(-cs) overflows fp32

    def f(x, dt, A, B, C):
        return jnp.sum(jssd_chunked_ref(x, dt, A, B, C, chunk)[0] * gy)

    jg = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(v) for v in (x, dt, A, B, C)))
    assert np.isnan(np.asarray(jg[1])).any() and np.isnan(np.asarray(jg[2])).any()
    assert all(np.isfinite(np.asarray(jg[i])).all() for i in (0, 3, 4))

    # the kernel's layout, (b h, s, .): the plain backward in fp32 against
    # float64 autograd
    lay = lambda v: torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, 2, 1)))
    ins = [lay(x).reshape(h, s, p), lay(dt).reshape(h, s), torch.from_numpy(A).reshape(h, 1),
           lay(B).reshape(h, s, n), lay(C).reshape(h, s, n)]
    gyk = lay(gy).reshape(h, s, p).double()
    gst = torch.zeros((h, 1, p, n), dtype=torch.float64)
    want = _autograd([v.double() for v in ins], gyk, gst, chunk)
    got = ssd.ssd_intra_chunk_bwd_plain(*ins, gyk.float(), gst.float(), chunk)
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= TOL["float32"], (name, _rel(g, w))

    args = [torch.from_numpy(v).requires_grad_() for v in (x, dt, A, B, C)]
    y, _ = ops.ssd_scan(*args, chunk=chunk)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum(), args)
    assert all(torch.isfinite(g).all() for g in grads)
    # the same gradient as the kernel layout's (the final state is unused)
    np.testing.assert_allclose(grads[2].numpy(), got[2].reshape(h).numpy(), rtol=1e-6)


@pytest.mark.parametrize("shape", [(640, 1024, 64, 128, 256), (640, 1024, 64, 64, 256),
                                   (1, 16, 8, 16, 16), (2, 1024, 128, 128, 512),
                                   (4, 96, 1, 128, 48), (65535, 256, 64, 64, 256)])
def test_bwd_domain_takes_the_training_shapes(shape):
    """mamba2-2.7b's (b 8 x 80 heads, s 1024, p 64, n 128, chunk 256) and
    zamba2-2.7b's (n 64) training shapes, the reduced configs' and the
    domain's edges are taken."""
    ssd.check_bwd_domain(*shape)
    assert ssd.bwd_smem_bytes(*shape[-1:], *shape[2:4]) <= ssd.SMEM_LIMIT


@pytest.mark.parametrize("shape,match", [
    ((2, 64, 129, 16, 16), "p from 1"), ((2, 64, 16, 0, 16), "n from 1"),
    ((2, 64, 16, 200, 16), "n from 1"), ((2, 100, 16, 16, 32), "multiple of chunk"),
    ((2, 16384, 128, 128, 16384), "shared memory"), ((65536, 64, 16, 16, 64), "65535"),
    ((2, 65536 * 16, 16, 16, 16), "65535")])
def test_bwd_domain_refuses_the_rest(shape, match):
    with pytest.raises(ValueError, match=match):
        ssd.check_bwd_domain(*shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_wrapper_dtypes_and_checks(dtype):
    """dx, dB and dC come back in the input's dtype, ddt and dA in fp32; the
    wrapper refuses gradients of the wrong dtype or shape; the Function's
    forward gives the forward's values."""
    ins, gy, gst = _kernel_inputs(2, 64, 8, 16, 32, seed=3, dtype=dtype)
    x, dt, A, B, C = (v.to(dtype) if v.dim() == 3 else v.float() for v in ins)
    gy, gst = gy.float(), gst.float()
    dx, ddt, dA, dB, dC = ssd.ssd_intra_chunk_bwd(x, dt, A, B, C, gy, gst, 32)
    assert (dx.dtype, dB.dtype, dC.dtype) == (dtype,) * 3
    assert (ddt.dtype, dA.dtype) == (torch.float32,) * 2
    assert dx.shape == x.shape and dB.shape == B.shape and ddt.shape == dt.shape
    assert dA.shape == A.shape
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_intra_chunk_bwd(x, dt, A, B, C, gy.double(), gst, 32)
    with pytest.raises(ValueError, match="shape"):
        ssd.ssd_intra_chunk_bwd(x, dt, A, B, C, gy, gst[:, :1], 32)
    y0, st0 = ssd.ssd_intra_chunk(x, dt, A, B, C, 32)
    y1, st1 = ssd.ssd_intra_chunk(x.requires_grad_(), dt, A, B, C, 32)
    assert y1.grad_fn is not None and y0.grad_fn is None
    assert torch.equal(y0, y1.detach()) and torch.equal(st0, st1.detach())
