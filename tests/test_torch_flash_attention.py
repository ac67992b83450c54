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
