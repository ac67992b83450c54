"""The arithmetic of the bf16 SSD kernel (``csrc/ssd_scan.cu``,
``ssd_intra_chunk_kernel``) against the JAX package, and the wrapper's
checks of the kernel's domain.

The kernel computes C Bᵀ from bf16 operands with fp32 sums (exact products),
weights the fp32 scores by exp(cs_i − cs_j) dt_j, splits the weighted
scores W into two bf16 terms (hi = bf16(W), lo = bf16(W − hi)) and sums
hi X + lo X in fp32; the chunk state likewise from X ⊙ w split into two
terms.  A plain emulation of that arithmetic must meet the tolerance that
``chip_smoke.py`` holds the kernel to (1e-4 of the largest magnitude of each
output) against ``repro.kernels.ssd_scan.ssd_intra_chunk`` (Pallas,
interpret mode) on the same numpy-made inputs; one bf16 term would not."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.ssd_scan import ssd_intra_chunk as jintra
from repro_torch.kernels import ssd_scan as ssd

# bh, s, p, n, chunk: the smoke's two bf16 shapes, cut to two heads
BF16_CASES = [(2, 512, 64, 64, 256), (2, 256, 128, 64, 128)]


def _inputs(seed, bh, s, p, n):
    """bf16 x, B, C and fp32 dt, A drawn as chip_smoke.py draws them."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
    x = bf(rng.normal(size=(bh, s, p)))
    B = bf(0.5 * rng.normal(size=(bh, s, n)))
    C = bf(0.5 * rng.normal(size=(bh, s, n)))
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.normal(size=(bh, s)).astype(np.float32)))
    A = -torch.exp(torch.from_numpy(0.5 * rng.normal(size=(bh, 1)).astype(np.float32)))
    return x, dt, A, B, C


def _split(v, terms):
    """v as a sum of ``terms`` bf16 values: bf16(v), then bf16 of what is left."""
    parts = []
    for _ in range(terms):
        part = v.bfloat16().float()
        parts.append(part)
        v = v - part
    return parts


def _kernel_numerics(x, dt, A, B, C, chunk, terms=2):
    """The bf16 kernel's arithmetic in PyTorch ops: fp32 sums of exact bf16
    products for C Bᵀ, the weighted scores and the state's weighted X in
    fp32, each split into ``terms`` bf16 terms whose exact products with the
    bf16 operand are summed in fp32."""
    bh, s, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    xf = x.float().reshape(bh, nc, chunk, p)
    Bf = B.float().reshape(bh, nc, chunk, n)
    Cf = C.float().reshape(bh, nc, chunk, n)
    dtc = dt.reshape(bh, nc, chunk)
    cs = torch.cumsum(dtc * A.reshape(bh, 1, 1), dim=-1)
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    L = torch.where(tril, torch.exp(cs[..., :, None] - cs[..., None, :]), 0.0)
    W = torch.matmul(Cf, Bf.transpose(-1, -2)) * L * dtc[..., None, :]
    y = sum(torch.matmul(part, xf) for part in _split(W, terms))
    xw = xf * (torch.exp(cs[..., -1:] - cs) * dtc)[..., None]
    states = sum(torch.matmul(part.transpose(-1, -2), Bf) for part in _split(xw, terms))
    return y.reshape(bh, s, p), states


def _reference(x, dt, A, B, C, chunk):
    """The JAX package's kernel (interpret mode) on the same inputs."""
    jbf = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jintra(jbf(x), jnp.asarray(dt.numpy()), jnp.asarray(A.numpy()), jbf(B), jbf(C),
                  chunk, interpret=True)


def _rel_errs(got, want):
    """Largest difference of each output over its largest magnitude."""
    want = [torch.from_numpy(np.array(w)) for w in want]
    return [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("i", range(len(BF16_CASES)))
def test_bf16_ssd_kernel_numerics_meet_reference_tolerance(i):
    bh, s, p, n, chunk = BF16_CASES[i]
    x, dt, A, B, C = _inputs(300 + i, bh, s, p, n)
    want = _reference(x, dt, A, B, C, chunk)
    errs = _rel_errs(_kernel_numerics(x, dt, A, B, C, chunk), want)
    assert max(errs) <= 1e-4, errs
    # the plain version, which the smoke holds the kernel to, agrees too
    assert max(_rel_errs(ssd.ssd_intra_chunk_plain(x, dt, A, B, C, chunk), want)) <= 1e-4


def test_one_bf16_term_misses_the_tolerance():
    """Why the kernel splits the weighted operand: rounded once to bf16, it
    misses 1e-4 of the largest output on the serving shape's chunk."""
    bh, s, p, n, chunk = BF16_CASES[0]
    x, dt, A, B, C = _inputs(300, bh, s, p, n)
    want = _reference(x, dt, A, B, C, chunk)
    errs = _rel_errs(_kernel_numerics(x, dt, A, B, C, chunk, terms=1), want)
    assert min(errs) > 1e-4, errs


def test_bf16_domain_is_checked():
    """The bf16 kernel takes chunks of a multiple of 64 rows, p and n
    multiples of 16 up to 128 within a block's shared memory, and tensors on
    a 16-byte boundary for the TMA; the serving shape passes."""
    bf = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)
    x, B, dt = bf(2, 1024, 64), bf(2, 1024, 64), torch.zeros(2, 1024)
    ssd.check_bf16_domain(x, dt, B, B, 256)  # zamba2-2.7b: p = n = 64, chunk 256
    ssd.check_bf16_domain(bf(2, 192, 16), dt[:, :192], bf(2, 192, 16), bf(2, 192, 16), 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        ssd.check_bf16_domain(x, dt, B, B, 32)
    with pytest.raises(ValueError, match="p a multiple of 16"):
        ssd.check_bf16_domain(bf(2, 1024, 72), dt, B, B, 256)
    with pytest.raises(ValueError, match="n a multiple of 16 up to 128"):
        ssd.check_bf16_domain(x, dt, bf(2, 1024, 144), bf(2, 1024, 144), 256)
    with pytest.raises(ValueError, match="shared memory"):
        ssd.check_bf16_domain(bf(2, 1024, 128), dt, bf(2, 1024, 128), bf(2, 1024, 128), 512)
    shifted = bf(2 * 1024 * 64 + 1)[1:].view(2, 1024, 64)  # 2 bytes past an aligned start
    with pytest.raises(ValueError, match="x must start on a 16-byte boundary"):
        ssd.check_bf16_domain(shifted, dt, B, B, 256)
    with pytest.raises(ValueError, match="dt must start on a 16-byte boundary"):
        ssd.check_bf16_domain(x, torch.zeros(2 * 1024 + 1)[1:].view(2, 1024), B, B, 256)
    # one stage at the serving shape, two where the kernel keeps the next chunk in flight
    assert ssd.bf16_smem_bytes(256, 64, 64) == 256 * 2 * 192 + 3 * 256 * 4 + 24 + 1024
    assert ssd.bf16_smem_bytes(256, 64, 64, stages=2) <= ssd.SMEM_LIMIT


def test_ssd_layout_probe_runs_on_the_card_only():
    bf = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_wgmma_layout_probe(bf(64, 64), bf(64, 64), bf(64, 64), torch.zeros(64, 64),
                                   torch.zeros(64))
