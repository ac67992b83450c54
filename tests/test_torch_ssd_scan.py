"""The port's SSD scan (``repro_torch.kernels``) against the JAX package:
``ops.ssd_scan`` (the plain version of ``ssd_intra_chunk_kernel`` plus the
inter-chunk scan) on the same numpy-made inputs as
``repro.kernels.ops.ssd_scan`` (Pallas, interpret mode) and
``repro.kernels.ref.ssd_scan_ref`` (the sequential recurrence), at the
tolerance of ``tests/test_kernels.py`` (2e-4).  The CUDA kernel itself is
checked on the card by ``chip_smoke.py``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_intra_chunk as jintra
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models.ssm import ssd_chunked_ref

TOL = 2e-4

# tests/test_kernels.py SSD_CASES: b, s, h, p, n, chunk
SSD_CASES = [
    (2, 64, 4, 8, 16, 16),
    (1, 96, 2, 64, 128, 32),
    (2, 100, 4, 8, 16, 32),   # padding path
    (1, 256, 2, 16, 32, 256), # single chunk
]


def _inputs(seed, b, s, h, p, n, with_init):
    rng = np.random.default_rng(seed)
    arrs = dict(
        x=rng.normal(size=(b, s, h, p)),
        dt=np.abs(rng.normal(size=(b, s, h))) * 0.5,
        A=-np.abs(rng.normal(size=(h,))),
        B=rng.normal(size=(b, s, h, n)),
        C=rng.normal(size=(b, s, h, n)),
    )
    if with_init:
        arrs["init_state"] = rng.normal(size=(b, h, p, n))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_scan_matches_reference(case, with_init):
    b, s, h, p, n, chunk = case
    j, t = _inputs(SSD_CASES.index(case) * 2 + with_init, b, s, h, p, n, with_init)
    jy, jH = jops.ssd_scan(j["x"], j["dt"], j["A"], j["B"], j["C"], chunk=chunk,
                           init_state=j.get("init_state"))
    ry, rH = jref.ssd_scan_ref(j["x"], j["dt"], j["A"], j["B"], j["C"],
                               init_state=j.get("init_state"))
    before = ssd.ssd_intra_chunk.launches
    y, H = ops.ssd_scan(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk=chunk,
                        init_state=t.get("init_state"))
    assert ssd.ssd_intra_chunk.launches == before  # the CPU runs the plain version
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, h, p)
    _close(y, jy)
    _close(H, jH)
    _close(y, ry)
    _close(H, rH)
    # the port's own oracles: the sequential recurrence and the chunked jnp path
    py, pH = ref.ssd_scan_ref(t["x"], t["dt"], t["A"], t["B"], t["C"],
                              init_state=t.get("init_state"))
    _close(py, ry)
    _close(pH, rH)
    cy, cH = ssd_chunked_ref(t["x"], t["dt"], t["A"], t["B"], t["C"], chunk,
                             init_state=t.get("init_state"))
    _close(cy, ry)
    _close(cH, rH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_chunk_plain_matches_pallas_kernel(dtype):
    """Kernel level, in the reference kernel's (b*h, s, .) layout, with x/B/C
    in the model's dtype (cast to fp32 inside, as the kernel casts)."""
    rng = np.random.default_rng(7)
    bh, s, p, n, chunk = 6, 96, 16, 32, 32
    x, B, C = (rng.normal(size=(bh, s, d)).astype(np.float32) for d in (p, n, n))
    dt = (np.abs(rng.normal(size=(bh, s))) * 0.5).astype(np.float32)
    A = (-np.abs(rng.normal(size=(bh, 1)))).astype(np.float32)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    jy, jst = jintra(*(jnp.asarray(a, jd) for a in (x,)), jnp.asarray(dt), jnp.asarray(A),
                     jnp.asarray(B, jd), jnp.asarray(C, jd), chunk, interpret=True)
    y, st = ssd.ssd_intra_chunk(torch.from_numpy(x).to(td), torch.from_numpy(dt),
                                torch.from_numpy(A), torch.from_numpy(B).to(td),
                                torch.from_numpy(C).to(td), chunk)
    assert y.dtype == st.dtype == torch.float32
    assert tuple(st.shape) == (bh, s // chunk, p, n)
    _close(y, jy)
    _close(st, jst)


def test_ssd_intra_chunk_wrapper_checks_its_inputs():
    x = torch.zeros(2, 16, 4)
    B = torch.zeros(2, 16, 8)
    dt = torch.zeros(2, 16)
    A = torch.zeros(2, 1)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd.ssd_intra_chunk(x, dt, A, B, B, chunk=5)
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_intra_chunk(x, dt.double(), A, B, B, chunk=8)
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_intra_chunk(x, dt, A, B.bfloat16(), B, chunk=8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ssd.ssd_intra_chunk(*(t.to("meta") for t in (x, dt, A, B, B)), chunk=8)
