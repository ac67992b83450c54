"""The port's flash attention (``repro_torch.kernels``) against the JAX
package: the plain version of ``flash_attention_kernel`` and
``ops.flash_attention`` on the same numpy-made inputs as
``repro.kernels.ops.flash_attention`` (Pallas, interpret mode) and
``repro.kernels.ref.flash_attention_ref``, at the tolerances of
``tests/test_kernels.py`` (5e-5 fp32, 3e-2 bf16).  On the CPU the wrapper
runs the plain version; the CUDA kernel itself is checked on the card by
``chip_smoke.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import attention as jattention
from repro.models.sharding import make_rules
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

# tests/test_kernels.py FA_CASES: b, sq, skv, h, kv, hd, causal, dtype, tol
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, jnp.float32, 5e-5),
    (2, 128, 128, 4, 4, 64, False, jnp.float32, 5e-5),
    (1, 256, 256, 4, 1, 128, True, jnp.float32, 5e-5),
    (1, 256, 256, 8, 8, 128, True, jnp.bfloat16, 3e-2),
    (2, 128, 256, 6, 2, 112, False, jnp.float32, 5e-5),
    (1, 128, 384, 8, 2, 128, True, jnp.bfloat16, 3e-2),
    (1, 512, 512, 2, 2, 64, True, jnp.float32, 5e-5),
]


def _case(seed, b, sq, skv, h, kv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, sq, h, hd)), rng.normal(size=(b, skv, kv, hd)),
            rng.normal(size=(b, skv, kv, hd))]
    arrs = [a.astype(np.float32) for a in arrs]
    # both frameworks round float32 to bfloat16 to nearest even: same bits
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrs]
    return jx, tx


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("i", range(len(FA_CASES)))
def test_flash_attention_matches_reference(i):
    b, sq, skv, h, kv, hd, causal, dtype, tol = FA_CASES[i]
    (jq, jk, jv), (q, k, v) = _case(i, b, sq, skv, h, kv, hd, dtype)
    off = skv - sq
    want_kernel = jops.flash_attention(jq, jk, jv, causal=causal, q_offset=off)
    want_ref = jref.flash_attention_ref(jq, jk, jv, causal=causal, q_offset=off)
    before = fa.flash_attention_fwd.launches
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=off)
    assert fa.flash_attention_fwd.launches == before  # the CPU runs the plain version
    assert got.dtype == q.dtype and tuple(got.shape) == (b, sq, h, hd)
    _close(got, want_kernel, tol)
    _close(got, want_ref, tol)
    # the kernel-level plain version in the reference kernel's layout
    plain = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                     causal=causal, q_offset=off)
    _close(plain.transpose(1, 2), want_ref, tol)
    # the port's own oracle
    _close(ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off), want_ref, tol)


# the model's shapes: hd = 80 (zamba2-2.7b, not padded to 128) and a ragged
# query/key length with GQA and q_offset, against the reference model's jnp
# path (chunk 128, so the reference pads and masks the last KV chunk)
MODEL_CASES = [
    # b, sq, skv, h, kv, hd, q_offset, dtype, tol
    (2, 96, 96, 4, 4, 80, 0, jnp.float32, 5e-5),
    (2, 96, 96, 4, 4, 80, 0, jnp.bfloat16, 3e-2),
    (1, 200, 328, 8, 2, 80, 128, jnp.float32, 5e-5),
    (1, 200, 328, 8, 2, 80, 128, jnp.bfloat16, 3e-2),
]


@pytest.mark.parametrize("i", range(len(MODEL_CASES)))
def test_flash_attention_model_shapes_match_jnp_attention(i):
    b, sq, skv, h, kv, hd, off, dtype, tol = MODEL_CASES[i]
    (jq, jk, jv), (q, k, v) = _case(100 + i, b, sq, skv, h, kv, hd, dtype)
    want = jattention(jq, jk, jv, make_rules(None, {}), causal=True, chunk=128, q_offset=off)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=off)
    _close(got, want, tol)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=True, q_offset=off), tol)


# The bf16 kernel's numerics (csrc/flash_attention.cu, flash_attention_kernel)
# differ from the reference's fp32 products of pre-scaled inputs: the
# tensor cores multiply bf16 q and k exactly and sum in fp32, the scale is
# applied to the fp32 scores (inside the exponent), and P is rounded to
# bf16 before P V.  A plain emulation of that arithmetic must still meet the
# reference's bf16 tolerance (3e-2, tests/test_kernels.py) against its
# oracle.
KERNEL_BF16_CASES = [
    # b, sq, skv, h, kv, hd, causal: the reference's two bf16 FA_CASES, then
    # zamba2-2.7b's head dim (80, h = kv) reduced, and a ragged GQA case
    (1, 256, 256, 8, 8, 128, True),
    (1, 128, 384, 8, 2, 128, True),
    (2, 256, 256, 4, 4, 80, True),
    (1, 200, 328, 8, 2, 80, True),
]


def _kernel_numerics(q, k, v, causal, q_offset, block_k=128):
    """The bf16 kernel's arithmetic in PyTorch ops, on (b, h, s, hd) bf16
    tensors: per tile of 128 keys, fp32 sums of exact bf16 products, masked
    scores -1e30, fp32 row maxima m of the unscaled scores, l and
    accumulators, p = 2^(s c - m c) with c = scale log2(e), row sums of the
    unrounded P, P rounded to bf16 for P V; the output divided by
    max(l, 1e-30) and rounded to bf16."""
    b, h, sq, hd = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    rep = h // kvh
    c = hd ** -0.5 * 1.4426950408889634
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    m = torch.full((b, h, sq, 1), fa.NEG_INF)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, hd)
    qpos = q_offset + torch.arange(sq)[:, None]
    for k0 in range(0, skv, block_k):
        s = torch.matmul(q.float(), kf[:, :, k0:k0 + block_k].transpose(-1, -2))
        if causal:
            kpos = k0 + torch.arange(s.shape[-1])[None, :]
            s = s.masked_fill(qpos < kpos, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.bfloat16().float(), vf[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("i", range(len(KERNEL_BF16_CASES)))
def test_bf16_kernel_numerics_meet_reference_tolerance(i):
    b, sq, skv, h, kv, hd, causal = KERNEL_BF16_CASES[i]
    (jq, jk, jv), (q, k, v) = _case(200 + i, b, sq, skv, h, kv, hd, jnp.bfloat16)
    off = skv - sq
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, q_offset=off)
    got = _kernel_numerics(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                           causal, off)
    _close(got.transpose(1, 2), want, 3e-2)


def test_flash_attention_wrapper_checks_its_inputs():
    q = torch.zeros(1, 2, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_fwd(q, k, torch.zeros(1, 2, 7, 16))
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention_fwd(q, k.double(), k)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention_fwd(torch.zeros(1, 3, 8, 16), k, k)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fa.flash_attention_fwd(q.to("meta"), k.to("meta"), k.to("meta"))


def test_bf16_strides_are_checked_for_the_tma():
    """The bf16 kernel's tensor maps need 16-byte aligned strides; a
    dimension of size 1 is never stepped, so its stride is replaced."""
    q = torch.zeros(2, 4, 24, 16, dtype=torch.bfloat16)
    assert fa._tma_strides("q", q) == [4 * 24 * 16, 24 * 16, 16]
    assert fa._tma_strides("q", q[:1, :, :1]) == [16, 24 * 16, 16]
    with pytest.raises(ValueError, match="16 bytes"):
        fa._tma_strides("q", torch.zeros(1, 2, 8, 20, dtype=torch.bfloat16)[..., :16])


def test_layout_probe_runs_on_the_card_only():
    x = torch.zeros(64, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fa.wgmma_layout_probe(x, torch.zeros(128, 16, dtype=torch.bfloat16),
                              torch.zeros(128, 16, dtype=torch.bfloat16))
