"""The port's dense serving path (``repro_torch.models.transformer`` through
``models.build_model``) against the JAX package, on reduced qwen3-32b
(qk-norm, GQA 4/2) and on reduced phi3-medium-14b at its own head counts
(40 Q heads padded to 48, 10 KV heads padded to 12), with the reference's
weights carried across by ``convert.params_from_reference``.  The reference
runs with ``use_pallas`` False (its jnp path) and True (its Pallas kernel
in interpret mode).

Tolerances are ``tests/test_torch_hybrid.py``'s: float32 at 1e-4 (atol and
rtol); a bf16 layer at the reference's own 6e-2/3e-2; a whole bf16 prefill
and decode no farther from the reference's float32 result than 3x the
reference's own bf16 result is (XLA and PyTorch round bf16 transcendentals
differently).  Greedy serving tokens must equal ``repro.serve``'s.
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
from repro.models import transformer as jtransformer
from repro.models.sharding import make_rules
from repro.serve import DecodeParams as JDecodeParams
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, transformer
from repro_torch.serve import DecodeParams, Request, ServingEngine

DENSE = ["qwen3-32b", "minitron-8b", "phi3-medium-14b", "codeqwen1.5-7b"]
RULES = make_rules(None, {})
SEQ, MAX_SEQ, STEPS = 19, 32, 2
# reduced phi3 keeps its head counts, so the reference's padding is reached
# (reduced_config's 4 heads need none)
HEADS = {"qwen3-32b": {}, "phi3-medium-14b": {"n_heads": 40, "n_kv_heads": 10}}


def _cfgs(arch, dtype):
    kw = dict(HEADS[arch], dtype=dtype)
    return (dataclasses.replace(jreduced_config(jget_config(arch)), **kw),
            dataclasses.replace(reduced_config(get_config(arch)), **kw))


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


@pytest.fixture(scope="module", params=[(a, d) for a in HEADS for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(jax config, jax params, port config, port model, port params) with the
    same weights."""
    jcfg, cfg = _cfgs(*request.param)
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    return (jcfg, jp, cfg, *_port(cfg, jp))


@pytest.mark.parametrize("arch", DENSE)
def test_configs_equal_the_reference(arch):
    full_j, full = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(reduced_config(full)) == dataclasses.asdict(jreduced_config(full_j))
    assert full.family == "dense" and full.resolved_head_dim == 128
    assert transformer.padded_dims(full) == jtransformer.padded_dims(full_j)


def test_padded_heads_reach_the_reduced_configs():
    assert transformer.padded_dims(_cfgs("phi3-medium-14b", "float32")[1]) == (48, 12, 256)
    assert transformer.padded_dims(get_config("phi3-medium-14b")) == (48, 12, 100352)
    qwen = get_config("qwen3-32b")
    assert (qwen.qk_norm, transformer.padded_dims(qwen)) == (True, (64, 8, 151936))
    assert _cfgs("qwen3-32b", "float32")[1].qk_norm


def test_params_from_reference_keeps_bits(pair):
    """Weights cross bit for bit (bf16 as its bits, never through float32)
    and the layer axis of ``blocks`` is unstacked."""
    _, jp, cfg, _, params = pair
    sd = params.state_dict()
    ref = jax.tree.map(np.asarray, jp)
    bits = {"float32": (np.int32, torch.int32), "bfloat16": (np.int16, torch.int16)}[cfg.dtype]

    def same(t, a):
        return np.array_equal(t.view(bits[1]).numpy(), a.view(bits[0]))

    assert set(params_from_reference(cfg, ref)) == set(sd)
    per_layer = 9 + 2 * cfg.qk_norm  # wq wk wv wo [q_norm k_norm] w1 w3 w2 ln1 ln2
    assert len(sd) == per_layer * cfg.n_layers + 3  # embed, final_norm, head
    blocks = ref["blocks"]
    for i in range(cfg.n_layers):
        for group in ("attn", "mlp"):
            for name, a in blocks[group].items():
                assert same(sd[f"blocks.{i}.{group}.{name}"], a[i]), (i, group, name)
        assert same(sd[f"blocks.{i}.ln1"], blocks["ln1"][i])
        assert same(sd[f"blocks.{i}.ln2"], blocks["ln2"][i])
    for name in ("embed", "final_norm", "head"):
        assert same(sd[name], ref[name]), name
    hp, kvp, _ = transformer.padded_dims(cfg)
    assert tuple(sd["blocks.0.attn.wq"].shape) == (cfg.d_model, hp, cfg.resolved_head_dim)
    assert tuple(sd["blocks.0.attn.wk"].shape) == (cfg.d_model, kvp, cfg.resolved_head_dim)


def _x(cfg, seed=1):
    x = np.random.default_rng(seed).normal(size=(2, SEQ, cfg.d_model)).astype(np.float32)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[cfg.dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dense_layer_matches_reference(pair, use_pallas):
    jcfg, jp, cfg, _, params = pair
    jx, tx = _x(cfg)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32)[None], (2, SEQ))
    lp = jax.tree.map(lambda a: a[1], jp["blocks"])
    jy, _, (jk, jv) = jtransformer.dense_layer(lp, jx, jnp.asarray(pos), jcfg, RULES,
                                               use_pallas=use_pallas)
    y, (k, v) = transformer.dense_layer(params.blocks[1], tx, torch.from_numpy(pos.copy()), cfg)
    atol, rtol = (1e-4, 1e-4) if cfg.dtype == "float32" else (6e-2, 3e-2)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want, atol, rtol)
    assert y.dtype == tx.dtype


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
    for arch in HEADS:
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
        assert c[key].dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
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


def test_greedy_serving_matches_reference():
    """Reduced qwen3-32b in float32: the port's engine and ``repro.serve``
    produce the same tokens, request by request, over two waves (the first
    mixes prompt lengths, left-padded with token 0)."""
    slots, max_new = 4, 6
    jcfg, cfg = _cfgs("qwen3-32b", "float32")
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


def test_launcher_defaults_to_qwen3(monkeypatch, capsys):
    """The launcher serves qwen3-32b unless told otherwise, as the
    reference's does, and on the CUDA device unless given ``--device cpu``."""
    asked = []

    def get_config_spy(name):
        asked.append(name)
        return get_config(name)

    monkeypatch.setattr(launch_serve, "get_config", get_config_spy)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_serve.main(["--requests", "1"])
    assert launch_serve.main(["--device", "cpu", "--requests", "2", "--slots", "2",
                              "--max-new", "2", "--prompt-len", "5", "--max-seq", "8"]) == 0
    assert asked[-1] == "qwen3-32b"
    assert capsys.readouterr().out.startswith("served 2 requests, 4 tokens | TTFT ")
