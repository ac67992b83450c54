"""The port's SSM family (mamba2: ``repro_torch.models.zoo`` through
``models.build_model``) against the JAX package, on reduced mamba2-2.7b
with 4 layers, the reference's weights carried across by
``convert.params_from_reference``.  The reference runs with ``use_pallas``
False (its jnp scan) and True (its Pallas SSD kernel in interpret mode).

Tolerances are ``tests/test_torch_hybrid.py``'s: float32 at 1e-4 (atol and
rtol; the conv state, cached in bf16 even in a float32 model, at one bf16
ulp); a whole bf16 prefill and decode no farther from the reference's
float32 result than 3x the reference's own bf16 result is.  Greedy serving
tokens must equal ``repro.serve``'s.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import build_model as jbuild_model
from repro.serve import DecodeParams as JDecodeParams
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model, ssm
from repro_torch.serve import DecodeParams, Request, ServingEngine

ARCH = "mamba2-2.7b"
SEQ, MAX_SEQ, STEPS = 19, 32, 2  # 19 tokens: 2 full chunks of 8 and a ragged one


def _cfgs(dtype, n_layers=4):
    return (dataclasses.replace(jreduced_config(jget_config(ARCH)), n_layers=n_layers, dtype=dtype),
            dataclasses.replace(reduced_config(get_config(ARCH)), n_layers=n_layers, dtype=dtype))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _rel(x, ref):
    return float(np.linalg.norm((_np(x) - _np(ref)).ravel()) / np.linalg.norm(_np(ref).ravel()))


def _port(cfg, jp):
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))
    return m, params


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(jax config, jax params, port config, port model, port params) with the
    same weights."""
    jcfg, cfg = _cfgs(request.param)
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    return (jcfg, jp, cfg, *_port(cfg, jp))


def test_configs_equal_the_reference():
    full_j, full = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(reduced_config(full)) == dataclasses.asdict(jreduced_config(full_j))
    assert full.family == "ssm" and full.ssm.d_state == 128 and full.ssm.chunk == 256
    assert ssm.ssm_dims(full) == dict(d_inner=5120, nheads=80, conv_dim=7168, proj_out=12368)


def test_params_from_reference_keeps_bits(pair):
    """Weights cross bit for bit (bf16 as its bits, never through float32)
    and the layer axis of ``mamba`` is unstacked."""
    _, jp, cfg, _, params = pair
    sd = params.state_dict()
    ref = jax.tree.map(np.asarray, jp)
    bits = {"float32": (np.int32, torch.int32), "bfloat16": (np.int16, torch.int16)}[cfg.dtype]

    def same(t, a):
        return np.array_equal(t.view(bits[1]).numpy(), a.view(bits[0]))

    assert set(params_from_reference(cfg, ref)) == set(sd)
    assert len(sd) == 9 * cfg.n_layers + 3  # 9 per Mamba layer; embed, final_norm, head
    for i in range(cfg.n_layers):
        for name, a in ref["mamba"].items():
            assert same(sd[f"mamba.{i}.{name}"], a[i]), (i, name)
    for name in ("embed", "final_norm", "head"):
        assert same(sd[name], ref[name]), name


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, size=(2, SEQ)).astype(np.int32)


def _run(prefill, decode, toks):
    """Prefill, then STEPS decode steps fed the prompt's first tokens:
    (logits per step, the cache after the prefill, the last cache)."""
    logits, cache = prefill(toks)
    after_prefill = {k: (np.array(_np(v)) if hasattr(v, "shape") and v.ndim else int(v))
                     for k, v in cache.items()}
    dtypes = {k: str(cache[k].dtype).split(".")[-1] for k in ("ssm", "conv")}
    out = [logits]
    for t in range(STEPS):
        logits, cache = decode(toks[:, t:t + 1], cache)
        out.append(logits)
    return out, after_prefill, dtypes, cache


@pytest.fixture(scope="module")
def ref32():
    """The reference's float32 prefill and decode on the same weights as the
    bf16 fixture (drawn in float32 from the same key)."""
    jcfg, _ = _cfgs("float32")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    return _run(lambda t: jm.prefill(jp, {"tokens": jnp.asarray(t)}, MAX_SEQ),
                lambda t, c: jm.decode_step(jp, jnp.asarray(t), c), _tokens(jcfg))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(pair, ref32, use_pallas):
    jcfg, jp, cfg, m, params = pair
    jm = jbuild_model(jcfg, use_pallas=use_pallas)
    toks = _tokens(cfg)
    want, jc0, jdt, jc = _run(lambda t: jm.prefill(jp, {"tokens": jnp.asarray(t)}, MAX_SEQ),
                              lambda t, c: jm.decode_step(jp, jnp.asarray(t), c), toks)
    got, c0, dt, c = _run(lambda t: m.prefill(params, {"tokens": t}, MAX_SEQ),
                          lambda t, c_: m.decode_step(params, t, c_), toks)
    assert c0["index"] == jc0["index"] == SEQ and c["index"] == int(jc["index"]) == SEQ + STEPS
    # the SSM state in fp32, the conv state in bf16, as the reference caches
    # them (also after decode steps of a float32 model)
    assert dt == jdt == {"ssm": "float32", "conv": "bfloat16"}
    assert (c["ssm"].dtype, c["conv"].dtype) == (torch.float32, torch.bfloat16)
    empty, jempty = m.init_cache(2, MAX_SEQ), jm.init_cache(2, MAX_SEQ)
    for key in ("ssm", "conv"):
        assert c0[key].shape == tuple(empty[key].shape) == jempty[key].shape, key
        assert str(empty[key].dtype).split(".")[-1] == str(jempty[key].dtype), key
    assert tuple(got[0].shape) == (2, 1, cfg.vocab_padded(16))
    if cfg.dtype == "float32":
        for g, w in zip(got, want):
            _close(g, w, 1e-4, 1e-4)
        for cache, jcache in ((c0, jc0), (c, jc)):
            _close(cache["ssm"], jcache["ssm"], 1e-4, 1e-4)
            _close(cache["conv"], jcache["conv"], 1e-4, 2.0 ** -8)  # stored in bf16
        return
    truth, truth_c0, _, truth_c = ref32
    pairs = list(zip(got, want, truth))
    pairs += [(c0[k], jc0[k], truth_c0[k]) for k in ("ssm", "conv")]
    pairs += [(c[k], jc[k], truth_c[k]) for k in ("ssm", "conv")]
    for g, w, t in pairs:
        assert _rel(g, t) <= 3 * _rel(w, t), (_rel(g, t), _rel(w, t))


def test_greedy_serving_matches_reference():
    """Reduced mamba2-2.7b in float32: the port's engine and ``repro.serve``
    produce the same tokens, request by request, over two waves (the first
    mixes prompt lengths, left-padded with token 0)."""
    slots, max_new = 4, 6
    jcfg, cfg = _cfgs("float32")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    m, params = _port(cfg, jp)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 9, 7, 8, 8, 8, 8)]

    def waves(engine, request_cls):
        done = []
        for w in range(0, len(prompts), slots):
            for rid in range(w, w + slots):
                engine.submit(request_cls(rid=rid, prompt=prompts[rid], max_new_tokens=max_new))
            engine.lanes = [None] * slots
            engine.cache = None
            done += engine.run()
        return {r.rid: r.out_tokens for r in done}

    want = waves(JServingEngine(jm, jp, max_seq=MAX_SEQ, slots=slots,
                                decode=JDecodeParams(temperature=0.0, max_new_tokens=max_new)),
                 JRequest)
    got = waves(ServingEngine(m, params, max_seq=MAX_SEQ, slots=slots,
                              decode=DecodeParams(temperature=0.0, max_new_tokens=max_new)),
                Request)
    assert got == want and len(got) == len(prompts)
    assert all(len(t) == max_new for t in got.values())
