"""The attention backward's plain version (``flash_attention_bwd_plain``, the
backward kernels' function) and the lse-returning plain forward against
``jax.grad`` of the JAX package's ``repro.kernels.ref.flash_attention_ref``
(its direct attention), over GQA, causal and non-causal attention, a
ragged ``q_offset`` and ragged lengths: at 5e-5 in fp32 (relative to each
gradient's largest magnitude) and 3e-2 in bf16.  Then the differentiable
entry point (``flash_attention``: the ``torch.autograd.Function`` on a CPU
tensor runs the plain versions both ways) against autograd through the
plain forward, and the wrapper's checks.  The CUDA kernels themselves run
only on the card (``chip_smoke.py`` phase 30)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jflash_attention_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

CASES = [  # b, h, kv, sq, skv, hd, q_offset, causal
    (2, 4, 4, 16, 16, 16, 0, True),
    (2, 8, 2, 19, 19, 16, 0, True),
    (1, 6, 2, 24, 40, 32, 16, True),
    (2, 4, 2, 13, 29, 64, 0, False),
    (1, 4, 1, 7, 7, 8, 0, True),
    (1, 2, 2, 5, 33, 128, 28, True),
]


def _inputs(b, h, kv, sq, skv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kv, hd)).astype(np.float32),
            rng.normal(size=(b, skv, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sq, h, hd)).astype(np.float32))


def _jax_grads(q, k, v, do, causal, q_offset, dtype):
    def f(q, k, v):
        o = jflash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
        return jnp.sum(o.astype(jnp.float32) * do)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    return [np.asarray(g, np.float32) for g in jax.grad(f, argnums=(0, 1, 2))(*args)]


def _t(x, dtype):
    """A (b, s, heads, hd) array as the kernel's (b, heads, s, hd) view."""
    return torch.from_numpy(x).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_bwd_plain_matches_jax_grad(case, dtype, tol):
    b, h, kv, sq, skv, hd, off, causal = case
    q, k, v, do = _inputs(b, h, kv, sq, skv, hd)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    # the same rounded inputs on both sides
    q, k, v = (np.asarray(jnp.asarray(x, jdt), np.float32) for x in (q, k, v))
    tq, tk, tv = _t(q, tdt), _t(k, tdt), _t(v, tdt)
    o, lse = fa.flash_attention_plain_lse(tq, tk, tv, causal=causal, q_offset=off)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, o, lse, _t(do, tdt), causal=causal,
                                         q_offset=off)
    want = _jax_grads(q, k, v, do.astype(np.float32) if dtype == "float32"
                      else np.asarray(jnp.asarray(do, jdt), np.float32), causal, off, jdt)
    for name, g, w, like in zip("qkv", grads, want, (tq, tk, tv)):
        assert g.dtype == like.dtype and g.shape == like.shape
        g = g.transpose(1, 2).float().numpy()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_lse_forward(case):
    """The plain forward's output is ``flash_attention_plain``'s and its lse
    the log-sum-exp of the scaled, masked logits."""
    b, h, kv, sq, skv, hd, off, causal = case
    q, k, v, _ = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(b, h, kv, sq, skv, hd))
    o, lse = fa.flash_attention_plain_lse(q, k, v, causal=causal, q_offset=off)
    assert torch.equal(o, fa.flash_attention_plain(q, k, v, causal=causal, q_offset=off))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double() * hd ** -0.5,
                     k.double().repeat_interleave(h // kv, dim=1))
    if causal:
        hide = (off + torch.arange(sq))[:, None] < torch.arange(skv)[None, :]
        s = s.masked_fill(hide, -1e30)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(), rtol=1e-6, atol=1e-5)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_autograd_function_on_cpu(case):
    """``flash_attention`` (and ``ops.flash_attention`` in the model's
    layout) differentiates like autograd through the plain forward, and the
    forward's output is unchanged."""
    b, h, kv, sq, skv, hd, off, causal = case
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(b, h, kv, sq, skv, hd, seed=1))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = ops.flash_attention(*leaves, causal=causal, q_offset=off)
    got = torch.autograd.grad(o, leaves, do)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    o_ref = fa.flash_attention_plain(*(x.transpose(1, 2) for x in ref), causal=causal,
                                     q_offset=off).transpose(1, 2)
    want = torch.autograd.grad(o_ref, ref, do)
    assert torch.equal(o.detach(), o_ref.detach())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_forward_without_gradients_takes_no_autograd_path():
    q, k, v, _ = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(1, 2, 2, 4, 4, 8))
    out = fa.flash_attention(q, k, v)
    assert out.grad_fn is None
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


def test_bwd_wrapper_checks_its_inputs():
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(1, 4, 2, 8, 8, 16))
    o, lse = fa.flash_attention_plain_lse(q, k, v)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_bwd(q, k, v, o[:, :, :4], lse, do)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_bwd(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_bwd(q, k, v, o, lse, do, q_offset=-1)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention_bwd(q[:, :3], k, v, o[:, :3], lse[:, :3], do[:, :3])
    n = fa.flash_attention_bwd.launches
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    assert fa.flash_attention_bwd.launches == n  # the plain version launches nothing


def test_fwd_returns_lse_on_request():
    q, k, v, _ = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(2, 4, 2, 9, 9, 16))
    o, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    assert torch.equal(o, fa.flash_attention_fwd(q, k, v))
    assert torch.equal(lse, fa.flash_attention_plain_lse(q, k, v)[1])
