"""The arithmetic of the bf16 attention backward kernels
(``csrc/flash_attention.cu``: ``flash_attention_bwd_dkdv_bf16_kernel`` and
``flash_attention_bwd_dq_bf16_kernel``) against the JAX package, and the
wrapper's checks of their domain.

The kernels compute S = q kᵀ and dP = do vᵀ from bf16 operands with fp32
sums (exact products), P = 2^(S·scale·log2 e − lse·log2 e) and
dS = P ∘ (dP − D) in fp32 (D = rowsum(do ∘ o) in fp32), round P and dS to
bf16 as the register A operands of dV = Pᵀ do, dK = dSᵀ q and dQ = dS k,
sum those in fp32, and round dq, dk and dv to bf16 once.  A plain emulation
of that arithmetic is held to ``jax.grad`` of the JAX package's
``repro.kernels.ref.flash_attention_ref`` in fp32 at the reference test's
bf16 tolerance (3e-2 of each gradient's largest magnitude, as
``tests/test_torch_flash_attention_bwd.py`` holds the plain version), and to
``flash_attention_bwd_plain`` at the tolerance ``chip_smoke.py`` phase 30
holds the kernels to (1e-2 relative Frobenius error).  The kernels
themselves run only on the card (phase 30)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jflash_attention_ref
from repro_torch.kernels import flash_attention as fa
from test_torch_flash_attention_bwd import CASES, _inputs

LOG2E = 1.4426950408889634
# b, h, kv, sq, skv, hd, q_offset, causal: the reference test's cases, then
# qwen3-32b's training shape and whisper-tiny's cross-attention, reduced
NUMERICS_CASES = CASES + [(1, 8, 1, 256, 256, 128, 0, True), (1, 2, 2, 64, 200, 64, 0, False)]


def _kernel_numerics(q, k, v, o, lse, do, causal, q_offset, scale):
    """The bf16 kernels' arithmetic in PyTorch ops on (b, heads, seq, hd)
    bf16 tensors and the forward's fp32 lse -> (dq, dk, dv) in bf16."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    qf, dof = q.float(), do.float()
    kf, vf = (t.float().repeat_interleave(rep, dim=1) for t in (k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2))  # fp32 sums of exact bf16 products
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(LOG2E, dtype=torch.float32)
    p = torch.exp2(s * c - lse[..., None] * torch.tensor(LOG2E, dtype=torch.float32))
    if causal:
        hide = (q_offset + torch.arange(sq))[:, None] < torch.arange(skv)[None, :]
        p = p.masked_fill(hide, 0.0)
    d = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - d)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()  # the register A operands
    dq = torch.matmul(dsb, kf) * scale
    dk = torch.matmul(dsb.transpose(-1, -2), qf).view(b, kvh, rep, skv, hd).sum(dim=2) * scale
    dv = torch.matmul(pb.transpose(-1, -2), dof).view(b, kvh, rep, skv, hd).sum(dim=2)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _case_tensors(case):
    """bf16 q, k, v, do in the model's layout seen as (b, heads, seq, hd),
    the plain forward's o and lse on them, and the same rounded values as
    fp32 numpy arrays in (b, seq, heads, hd)."""
    b, h, kv, sq, skv, hd, off, causal = case
    arrays = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
              for x in _inputs(b, h, kv, sq, skv, hd)]
    q, k, v, do = (torch.from_numpy(x).bfloat16().transpose(1, 2) for x in arrays)
    o, lse = fa.flash_attention_plain_lse(q, k, v, causal=causal, q_offset=off)
    return (q, k, v, o, lse, do), arrays


def _jax_grads_f32(q, k, v, do, causal, q_offset):
    def f(q, k, v):
        o = jflash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
        return jnp.sum(o * do)

    return [np.asarray(g, np.float32)
            for g in jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))]


@pytest.mark.parametrize("case", NUMERICS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_numerics_match_jax_grad(case):
    (q, k, v, o, lse, do), arrays = _case_tensors(case)
    off, causal = case[6], case[7]
    got = _kernel_numerics(q, k, v, o, lse, do, causal, off, q.shape[-1] ** -0.5)
    want = _jax_grads_f32(*arrays, causal, off)
    for name, g, w in zip("qkv", got, want):
        g = g.transpose(1, 2).float().numpy()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 3e-2, (name, err)


@pytest.mark.parametrize("case", NUMERICS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_bf16_numerics_match_plain(case):
    (q, k, v, o, lse, do), _ = _case_tensors(case)
    off, causal = case[6], case[7]
    got = _kernel_numerics(q, k, v, o, lse, do, causal, off, q.shape[-1] ** -0.5)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, q_offset=off)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and g.shape == w.shape
        err = float((g.float() - w.float()).norm() / w.float().norm())
        assert err <= 1e-2, (name, err)


# the bf16 shapes chip_smoke.py phase 30 runs: (b, h, kv, sq, skv, hd)
PHASE30_BF16 = [(4, 64, 8, 1024, 1024, 128), (8, 6, 6, 1500, 1500, 64), (8, 6, 6, 448, 448, 64),
                (8, 6, 6, 448, 1500, 64), (2, 8, 2, 200, 328, 128), (1, 4, 4, 77, 205, 80),
                (2, 4, 2, 19, 19, 16), (2, 6, 2, 128, 256, 112), (8, 32, 32, 1024, 1024, 80),
                (1, 48, 8, 1024, 1024, 128), (1, 64, 8, 1024, 1024, 112),
                (8, 12, 2, 1088, 1088, 128), (8, 48, 12, 1024, 1024, 128)]


def _model_layout(b, h, kv, sq, skv, hd, pad=0):
    """bf16 q, k, v, o, do and the wrapper's dq, dk, dv as (b, heads, seq,
    hd) views of (b, seq, heads, hd + pad) tensors (nothing is written)."""
    mk = lambda s, n: torch.empty((b, s, n, hd + pad), dtype=torch.bfloat16)[..., :hd].transpose(1, 2)
    return [mk(sq, h), mk(skv, kv), mk(skv, kv), mk(sq, h), mk(sq, h), mk(sq, h), mk(skv, kv),
            mk(skv, kv)]


@pytest.mark.parametrize("shape", PHASE30_BF16, ids=lambda c: "-".join(map(str, c)))
def test_bf16_bwd_domain_takes_phase30_shapes(shape):
    st = fa.check_bf16_bwd_domain(*_model_layout(*shape))
    b, h, kv, sq, skv, hd = shape
    # (batch, head, seq) strides of q, k, v, o, do, dq, dk, dv in elements;
    # a batch of one is never stepped, so its stride is given as hd
    sb = lambda n: n if b > 1 else hd
    want = [[sb(s * n * hd), hd, n * hd] for s, n in ((sq, h), (skv, kv), (skv, kv))]
    assert st == [*want[0], *want[1], *want[2], *want[0], *want[0], *want[0], *want[1], *want[2]]


def test_bf16_bwd_domain_refuses():
    with pytest.raises(ValueError, match="hd a multiple of 8 up to 128"):
        fa.check_bf16_bwd_domain(*_model_layout(2, 4, 2, 64, 64, 12))
    with pytest.raises(ValueError, match="hd a multiple of 8 up to 128"):
        fa.check_bf16_bwd_domain(*_model_layout(2, 4, 2, 64, 64, 136))
    tensors = _model_layout(2, 4, 2, 64, 64, 64)
    shifted = torch.empty(2 * 64 * 4 * 64 + 1, dtype=torch.bfloat16)[1:]  # 2 bytes past
    tensors[0] = shifted.view(2, 64, 4, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="q must start on a 16-byte boundary"):
        fa.check_bf16_bwd_domain(*tensors)
    # rows of hd + 4 = 68 elements: 136-byte strides, which the TMA cannot step
    tensors = _model_layout(2, 4, 2, 64, 64, 64, pad=4)
    with pytest.raises(ValueError, match="q has stride 68 elements in dimension 1"):
        fa.check_bf16_bwd_domain(*tensors)
    tensors = _model_layout(2, 4, 2, 64, 64, 64)
    tensors[4] = torch.empty((2, 64, 4, 64), dtype=torch.bfloat16).transpose(1, 3).transpose(1, 2)
    with pytest.raises(ValueError, match="do must be contiguous in its last dimension"):
        fa.check_bf16_bwd_domain(*tensors)


def test_bwd_layout_probe_runs_on_the_card_only():
    bf = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.wgmma_bwd_layout_probe(bf(64, 64), bf(64, 64), bf(128, 64), bf(128, 64))
