"""The port's moe family (``repro_torch.models.moe`` and the moe branch of
``models.transformer``, through ``models.build_model``) against the JAX
package, on reduced kimi-k2-1t-a32b (8 experts, top-2, one shared expert)
and reduced grok-1-314b (4 experts, top-2, no shared expert), with the
reference's weights carried across by ``convert.params_from_reference``.
The reference runs with ``use_pallas`` False (its jnp path) and True (its
Pallas kernel in interpret mode) where attention is on the path.

Tolerances are ``tests/test_torch_dense.py``'s: float32 at 1e-4 (atol and
rtol); a bf16 layer at the reference's own 6e-2/3e-2; a whole bf16 prefill
and decode no farther from the reference's float32 result than 3x the
reference's own bf16 result is.  The router's aux loss is fp32 at 1e-6
relative.  Dispatch positions and the top-k order are exact.  Greedy
serving tokens must equal ``repro.serve``'s.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.sharding import make_rules
from repro.serve import DecodeParams as JDecodeParams
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model, moe, transformer
from repro_torch.models.common import Initializer
from repro_torch.serve import DecodeParams, Request, ServingEngine

MOE = ["kimi-k2-1t-a32b", "grok-1-314b"]
RULES = make_rules(None, {})
SEQ, MAX_SEQ, STEPS = 19, 32, 2
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jreduced_config(jget_config(arch)), dtype=dtype, **kw),
            dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype, **kw))


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


@pytest.fixture(scope="module", params=[(a, d) for a in MOE for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(jax config, jax params, port config, port model, port params) with the
    same weights."""
    jcfg, cfg = _cfgs(*request.param)
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    return (jcfg, jp, cfg, *_port(cfg, jp))


@pytest.mark.parametrize("arch", MOE)
def test_configs_equal_the_reference(arch):
    full_j, full = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(reduced_config(full)) == dataclasses.asdict(jreduced_config(full_j))
    assert full.family == "moe" and transformer.padded_dims(full) == jtransformer.padded_dims(full_j)
    assert moe._capacity(4096, full.moe) == jmoe._capacity(4096, full_j.moe)
    assert moe._capacity(4, full.moe) == jmoe._capacity(4, full_j.moe) == 4
    assert {"kimi-k2-1t-a32b": (384, 8, 1, 108, 112),
            "grok-1-314b": (8, 2, 0, 1280, 128)}[arch] == (
        full.moe.n_experts, full.moe.top_k, full.moe.n_shared_experts,
        moe._capacity(4096, full.moe), full.resolved_head_dim)


def test_params_from_reference_keeps_bits(pair):
    """Weights cross bit for bit (bf16 as its bits) and each MoE tensor,
    the shared expert's included, is unstacked by layer."""
    _, jp, cfg, _, params = pair
    sd = params.state_dict()
    ref = jax.tree.map(np.asarray, jp)
    bits = {"float32": (np.int32, torch.int32), "bfloat16": (np.int16, torch.int16)}[cfg.dtype]

    def same(t, a):
        return np.array_equal(t.view(bits[1]).numpy(), a.view(bits[0]))

    assert set(params_from_reference(cfg, ref)) == set(sd)
    shared = 3 if cfg.moe.n_shared_experts else 0
    assert len(sd) == (4 + 4 + shared + 2) * cfg.n_layers + 3
    mo = ref["blocks"]["moe"]
    for i in range(cfg.n_layers):
        for name in ("router", "w1", "w3", "w2"):
            assert same(sd[f"blocks.{i}.moe.{name}"], mo[name][i]), (i, name)
        for name, a in mo.get("shared", {}).items():
            assert same(sd[f"blocks.{i}.moe.shared.{name}"], a[i]), (i, name)
    E, d, fe = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert tuple(sd["blocks.0.moe.w1"].shape) == (E, d, fe)
    assert tuple(sd["blocks.0.moe.w2"].shape) == (E, fe, d)
    assert tuple(sd["blocks.0.moe.router"].shape) == (d, E)


def test_experts_are_drawn_one_at_a_time():
    """``Initializer.normal_stack`` fills a stack of the target dtype one
    slice at a time with the reference's std rule (fan-in = shape[-2])."""
    ini = Initializer(0, torch.bfloat16, torch.device("cpu"))
    w = ini.normal_stack((6, 256, 64))
    assert w.dtype == torch.bfloat16 and tuple(w.shape) == (6, 256, 64)
    stds = w.float().std(dim=(1, 2))
    assert torch.allclose(stds, torch.full((6,), 256 ** -0.5), rtol=0.05)
    assert not torch.equal(w[0], w[1])
    _, cfg = _cfgs("kimi-k2-1t-a32b", "bfloat16")
    p = build_model(cfg, device="cpu").init(0)
    assert p.blocks[0].moe.w1.dtype == torch.bfloat16
    assert float(p.blocks[0].moe.router.float().std()) == pytest.approx(0.02, rel=0.1)


def _x(cfg, seed=1):
    x = np.random.default_rng(seed).normal(size=(2, SEQ, cfg.d_model)).astype(np.float32)
    jd, td = DT[cfg.dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("capacity_factor", [None, 0.25], ids=["reduced-cf", "cf-0.25"])
def test_moe_ffn_matches_reference(pair, capacity_factor):
    """y and the aux loss of one layer's MoE FFN, at the reduced capacity
    factor (4.0: nothing dropped) and at 0.25 (tokens dropped, as
    ``tests/test_models.py::test_moe_balance_and_dropping``)."""
    jcfg, jp, cfg, _, params = pair
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jx, tx = _x(cfg)
    layer0 = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    jy, jaux = jmoe.moe_ffn(layer0, jx, jcfg, RULES)
    y, aux = moe.moe_ffn(params.blocks[0].moe, tx, cfg)
    atol, rtol = (1e-4, 1e-4) if cfg.dtype == "float32" else (6e-2, 3e-2)
    _close(y, jy, atol, rtol)
    assert y.dtype == tx.dtype and aux.dtype == torch.float32 and aux.dim() == 0
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    # at 0.25 some assignments are dropped (the capacity is below the load)
    t = 2 * SEQ
    eids = moe._route(tx.reshape(t, -1), params.blocks[0].moe.router, cfg.moe)[2]
    pos = moe._positions_in_expert(eids.reshape(-1), cfg.moe.n_experts)
    dropped = int((pos >= moe._capacity(t, cfg.moe)).sum())
    assert (dropped > 0) == (capacity_factor == 0.25)


@pytest.mark.parametrize("seed", range(3))
def test_positions_in_expert_exact(seed):
    rng = np.random.default_rng(seed)
    E = [8, 4, 384][seed]
    e_flat = rng.integers(0, E, size=[64, 37, 4096][seed]).astype(np.int32)
    want = np.asarray(jmoe._positions_in_expert(jnp.asarray(e_flat), E))
    got = moe._positions_in_expert(torch.from_numpy(e_flat).long(), E).numpy()
    np.testing.assert_array_equal(got, want)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal gates are taken lower index first, as ``lax.top_k`` takes
    them; with a zero router every gate ties and both pick experts 0..k-1,
    and the whole FFN matches."""
    gates = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.3, 0.1, 0.3, 0.3], [0.2, 0.4, 0.2, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(gates), 3)
    v, i = moe._top_k(torch.from_numpy(gates), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    jcfg, cfg = _cfgs("kimi-k2-1t-a32b", "float32")
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    jp["blocks"]["moe"]["router"] = jnp.zeros_like(jp["blocks"]["moe"]["router"])
    _, params = _port(cfg, jp)
    jx, tx = _x(cfg)
    layer0 = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    jy, jaux = jmoe.moe_ffn(layer0, jx, jcfg, RULES)
    y, aux = moe.moe_ffn(params.blocks[0].moe, tx, cfg)
    eids = moe._route(tx.reshape(2 * SEQ, -1), params.blocks[0].moe.router, cfg.moe)[2]
    assert (eids == torch.arange(cfg.moe.top_k)).all()
    _close(y, jy, 1e-4, 1e-4)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_moe_layer_matches_reference(pair, use_pallas):
    jcfg, jp, cfg, _, params = pair
    jx, tx = _x(cfg)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32)[None], (2, SEQ))
    lp = jax.tree.map(lambda a: a[1], jp["blocks"])
    jy, jaux, (jk, jv) = jtransformer.dense_layer(lp, jx, jnp.asarray(pos), jcfg, RULES,
                                                  use_pallas=use_pallas)
    y, (k, v) = transformer.dense_layer(params.blocks[1], tx, torch.from_numpy(pos.copy()), cfg)
    atol, rtol = (1e-4, 1e-4) if cfg.dtype == "float32" else (6e-2, 3e-2)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want, atol, rtol)
    assert y.dtype == tx.dtype and float(jaux) > 0


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab, size=(2, SEQ)).astype(np.int32)


def _run(prefill, decode, toks):
    """Prefill, then STEPS decode steps fed the prompt's first tokens:
    (logits per step, the cache after the prefill, the last cache)."""
    logits, cache = prefill(toks)
    after_prefill = {k: (np.array(_np(v)) if hasattr(v, "shape") and v.ndim else int(v))
                     for k, v in cache.items()}
    out = [logits]
    for t in range(STEPS):
        logits, cache = decode(toks[:, t:t + 1], cache)
        out.append(logits)
    return out, after_prefill, cache


@pytest.fixture(scope="module")
def ref32():
    """The reference's float32 prefill and decode for each arch, on the same
    weights as the bf16 fixtures (drawn in float32 from the same key)."""
    out = {}
    for arch in MOE:
        jcfg, _ = _cfgs(arch, "float32")
        jm = jbuild_model(jcfg)
        jp = jm.init(jax.random.key(0))
        out[arch] = _run(lambda t: jm.prefill(jp, {"tokens": jnp.asarray(t)}, MAX_SEQ),
                         lambda t, c: jm.decode_step(jp, jnp.asarray(t), c), _tokens(jcfg))
    return out


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(pair, ref32, use_pallas):
    jcfg, jp, cfg, m, params = pair
    jm = jbuild_model(jcfg, use_pallas=use_pallas)
    toks = _tokens(cfg)
    want, jc0, jc = _run(lambda t: jm.prefill(jp, {"tokens": jnp.asarray(t)}, MAX_SEQ),
                         lambda t, c: jm.decode_step(jp, jnp.asarray(t), c), toks)
    got, c0, c = _run(lambda t: m.prefill(params, {"tokens": t}, MAX_SEQ),
                      lambda t, c_: m.decode_step(params, t, c_), toks)
    assert c0["index"] == jc0["index"] == SEQ and c["index"] == int(jc["index"]) == SEQ + STEPS
    empty, jempty = m.init_cache(2, MAX_SEQ), jm.init_cache(2, MAX_SEQ)
    for key in ("k", "v"):
        assert c0[key].shape == tuple(empty[key].shape) == jc[key].shape, key
        assert str(empty[key].dtype).split(".")[-1] == str(jempty[key].dtype), key
        assert c[key].dtype == DT[cfg.dtype][1]
    assert tuple(got[0].shape) == (2, 1, cfg.vocab_padded(16))
    if cfg.dtype == "float32":
        for g, w in zip(got, want):
            _close(g, w, 1e-4, 1e-4)
        for key in ("k", "v"):
            _close(c0[key], jc0[key], 1e-4, 1e-4)
            _close(c[key], jc[key], 1e-4, 1e-4)
        return
    truth, truth_c0, truth_c = ref32[cfg.name.removesuffix("-reduced")]
    pairs = list(zip(got, want, truth))
    pairs += [(c0[k], jc0[k], truth_c0[k]) for k in ("k", "v")]
    pairs += [(c[k], jc[k], truth_c[k]) for k in ("k", "v")]
    for g, w, t in pairs:
        assert _rel(g, t) <= 3 * _rel(w, t), (_rel(g, t), _rel(w, t))


@pytest.mark.parametrize("arch", MOE)
def test_greedy_serving_matches_reference(arch):
    """Reduced moe configs in float32: the port's engine and ``repro.serve``
    produce the same tokens, request by request, over two waves (the first
    mixes prompt lengths, left-padded with token 0)."""
    slots, max_new = 4, 6
    jcfg, cfg = _cfgs(arch, "float32")
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
