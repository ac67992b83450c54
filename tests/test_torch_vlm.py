"""The port's vlm family (qwen2-vl-2b: M-RoPE in ``models.common.apply_rope``,
image embeddings before the text in ``models.transformer``) against the JAX
package, with the reference's weights carried across by
``convert.params_from_reference``.

M-RoPE is checked at head_dim 128 with three *distinct* position streams
(the reference's own test uses equal streams, which cannot tell M-RoPE from
RoPE), and the model at a reduced config with ``head_dim=128``: at the
reduced head_dim 16 the half-dim is 8, so only the temporal section is
reached.  The reference runs with ``use_pallas`` False and True (its Pallas
kernel in interpret mode).  Tolerances are ``tests/test_torch_dense.py``'s:
float32 at 1e-4 (atol and rtol); a bf16 layer at 6e-2/3e-2; a whole bf16
prefill and decode no farther from the reference's float32 result than 3x
the reference's own bf16 result is; ``apply_rope`` in float32 at 1e-6.
Greedy text-only serving tokens must equal ``repro.serve``'s.
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
from repro.models import common as jcommon
from repro.models import transformer as jtransformer
from repro.models.sharding import make_rules
from repro.serve import DecodeParams as JDecodeParams
from repro.serve import Request as JRequest
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.models import build_model, common, transformer
from repro_torch.serve import DecodeParams, Request, ServingEngine

ARCH = "qwen2-vl-2b"
RULES = make_rules(None, {})
TXT, MAX_SEQ, STEPS = 11, 40, 2
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype, **kw):
    return (dataclasses.replace(jreduced_config(jget_config(ARCH)), dtype=dtype, **kw),
            dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dtype, **kw))


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


def _positions(b, img, txt, seed=0):
    """Three distinct streams: the image on a grid (t = 0, h = row + a
    per-lane shift, w = col), then the text at the same position on all
    three, after the grid's largest."""
    side = int(np.ceil(np.sqrt(img)))
    i = np.arange(img)
    shift = np.random.default_rng(seed).integers(0, 3, size=(b, 1))
    grid = np.stack([np.zeros((b, img)), i // side + shift, np.broadcast_to(i % side, (b, img))])
    text = side + 3 + np.arange(txt)
    return np.concatenate([grid, np.broadcast_to(text, (3, b, txt))], axis=2).astype(np.int32)


def test_config_equals_the_reference():
    full_j, full = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(reduced_config(full)) == dataclasses.asdict(jreduced_config(full_j))
    assert (full.family, full.mrope, full.img_tokens, full.resolved_head_dim) == (
        "vlm", True, 1024, 128)
    assert transformer.padded_dims(full) == jtransformer.padded_dims(full_j) == (12, 2, 151936)
    assert transformer.MROPE_SECTIONS == jtransformer.MROPE_SECTIONS


@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)), (16, (16, 24, 24)), (64, None)],
                         ids=["mrope-hd128", "mrope-hd16", "rope-hd64"])
def test_apply_rope_matches_reference(hd, sections):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 13, 3, hd)).astype(np.float32)
    if sections is None:
        pos = rng.integers(0, 500, size=(2, 13)).astype(np.int32)
    else:
        pos = rng.integers(0, 500, size=(3, 2, 13)).astype(np.int32)
        assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    _close(got, want, 1e-6, 1e-6)
    if sections is not None and hd == 128:  # the streams matter: not plain RoPE
        plain = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6)
        assert not torch.allclose(got, plain, atol=1e-3)
    if sections is not None and hd == 16:  # only the temporal stream is reached
        plain = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]), 1e6)
        torch.testing.assert_close(got, plain, atol=0, rtol=0)
    with pytest.raises(ValueError, match="M-RoPE"):
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0] if pos.ndim == 3 else pos),
                          1e6, (16, 24, 24))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(jax config, jax params, port config, port model, port params) with the
    same weights, at head_dim 128 so every M-RoPE section is reached."""
    jcfg, cfg = _cfgs(request.param, head_dim=128)
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    return (jcfg, jp, cfg, *_port(cfg, jp))


def test_params_from_reference_keeps_bits(pair):
    _, jp, cfg, _, params = pair
    sd = params.state_dict()
    ref = jax.tree.map(np.asarray, jp)
    bits = {"float32": (np.int32, torch.int32), "bfloat16": (np.int16, torch.int16)}[cfg.dtype]
    assert set(params_from_reference(cfg, ref)) == set(sd)
    assert len(sd) == 9 * cfg.n_layers + 3
    for i in range(cfg.n_layers):
        for group in ("attn", "mlp"):
            for name, a in ref["blocks"][group].items():
                t = sd[f"blocks.{i}.{group}.{name}"]
                assert np.array_equal(t.view(bits[1]).numpy(), a[i].view(bits[0])), (i, name)


def _batch(cfg, seed=0):
    """A vlm batch: tokens, seeded image embeddings, distinct positions."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(2, cfg.img_tokens, cfg.d_model)).astype(np.float32)
    return {"tokens": rng.integers(0, cfg.vocab, size=(2, TXT)).astype(np.int32),
            "img_embeds": img, "positions": _positions(2, cfg.img_tokens, TXT, seed)}


def _jbatch(batch, cfg):
    jd = DT[cfg.dtype][0]
    return {k: jnp.asarray(v, jd if k == "img_embeds" else None) for k, v in batch.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_layer_with_distinct_streams_matches_reference(pair, use_pallas):
    jcfg, jp, cfg, _, params = pair
    s = cfg.img_tokens + TXT
    x = np.random.default_rng(1).normal(size=(2, s, cfg.d_model)).astype(np.float32)
    jd, td = DT[cfg.dtype]
    pos = _positions(2, cfg.img_tokens, TXT)
    lp = jax.tree.map(lambda a: a[1], jp["blocks"])
    jy, _, (jk, jv) = jtransformer.dense_layer(lp, jnp.asarray(x, jd), jnp.asarray(pos), jcfg,
                                               RULES, use_pallas=use_pallas)
    y, (k, v) = transformer.dense_layer(params.blocks[1], torch.from_numpy(x).to(td),
                                        torch.from_numpy(pos), cfg)
    atol, rtol = (1e-4, 1e-4) if cfg.dtype == "float32" else (6e-2, 3e-2)
    for got, want in ((y, jy), (k, jk), (v, jv)):
        _close(got, want, atol, rtol)


def _run(prefill, decode, batch):
    """Prefill the batch, then STEPS decode steps fed its first tokens:
    (logits per step, the cache after the prefill, the last cache)."""
    logits, cache = prefill(batch)
    after_prefill = {k: (np.array(_np(v)) if hasattr(v, "shape") and v.ndim else int(v))
                     for k, v in cache.items()}
    out = [logits]
    for t in range(STEPS):
        logits, cache = decode(batch["tokens"][:, t:t + 1], cache)
        out.append(logits)
    return out, after_prefill, cache


def _jax_run(jm, jp, batch, cfg):
    jbatch = _jbatch(batch, cfg)
    return _run(lambda b: jm.prefill(jp, jbatch, MAX_SEQ),
                lambda t, c: jm.decode_step(jp, jnp.asarray(t), c), batch)


@pytest.fixture(scope="module")
def ref32():
    """The reference's float32 prefill and decode on the same weights as the
    bf16 fixture (drawn in float32 from the same key)."""
    jcfg, _ = _cfgs("float32", head_dim=128)
    jm = jbuild_model(jcfg)
    return _jax_run(jm, jm.init(jax.random.key(0)), _batch(jcfg), jcfg)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_with_images_and_decode_match_reference(pair, ref32, use_pallas):
    """The image embeddings come before the text and the (3, b, s) streams
    are distinct; decode positions are the cache index on every stream."""
    jcfg, jp, cfg, m, params = pair
    jm = jbuild_model(jcfg, use_pallas=use_pallas)
    batch = _batch(cfg)
    if cfg.dtype == "bfloat16":  # the port takes the batch's bf16 image embeddings as given
        batch["img_embeds"] = np.asarray(jnp.asarray(batch["img_embeds"], jnp.bfloat16))
    want, jc0, jc = _jax_run(jm, jp, batch, cfg)
    got, c0, c = _run(lambda b: m.prefill(params, b, MAX_SEQ),
                      lambda t, c_: m.decode_step(params, t, c_), batch)
    s = cfg.img_tokens + TXT
    assert c0["index"] == jc0["index"] == s and c["index"] == int(jc["index"]) == s + STEPS
    assert tuple(got[0].shape) == (2, 1, cfg.vocab_padded(16))
    if cfg.dtype == "float32":
        for g, w in zip(got, want):
            _close(g, w, 1e-4, 1e-4)
        for key in ("k", "v"):
            _close(c0[key], jc0[key], 1e-4, 1e-4)
            _close(c[key], jc[key], 1e-4, 1e-4)
        return
    truth, truth_c0, truth_c = ref32
    pairs = list(zip(got, want, truth))
    pairs += [(c0[k], jc0[k], truth_c0[k]) for k in ("k", "v")]
    pairs += [(c[k], jc[k], truth_c[k]) for k in ("k", "v")]
    for g, w, t in pairs:
        assert _rel(g, t) <= 3 * _rel(w, t), (_rel(g, t), _rel(w, t))


def test_text_only_positions_default_to_equal_streams(pair):
    """Without ``positions`` a text-only prefill rotates every stream by
    0..s-1, which is what passing them equal gives."""
    _, _, cfg, m, params = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, TXT)).astype(np.int32)
    pos = np.broadcast_to(np.arange(TXT, dtype=np.int32), (3, 2, TXT)).copy()
    a, ca = m.prefill(params, {"tokens": toks}, MAX_SEQ)
    b, cb = m.prefill(params, {"tokens": toks, "positions": pos}, MAX_SEQ)
    assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])


def test_text_only_greedy_serving_matches_reference():
    """The reference's engine passes only tokens to prefill, so it serves
    qwen2-vl as text; the port's engine gives the same tokens (float32, two
    waves, mixed prompt lengths in the first)."""
    slots, max_new = 4, 6
    jcfg, cfg = _cfgs("float32", head_dim=128)
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
