"""The port's encdec family (whisper-tiny: ``repro_torch.models.encdec``
through ``models.build_model``) against the JAX package, on reduced
whisper-tiny (2 encoder and 2 decoder layers, enc_seq 16), with the
reference's weights carried across by ``convert.params_from_reference``.
The reference runs with ``use_pallas`` False and True (its Pallas kernel in
interpret mode; its blocks must divide the sequence, which enc_seq 16
does).

Tolerances: bf16 (the encoder, a whole prefill and decode) no farther from
the reference's float32 result than 3x the reference's own bf16 result is
(``tests/test_torch_dense.py``'s rule for a whole bf16 model).
float32 is held at 1e-4 (atol and rtol) for the encoder and at 1e-3 for the
decoder's logits and caches.  The reduced model has no qk-norm and its key
weights have fan-in kv = 2, so attention logits reach ~120, where float32's
ulp is 7.6e-6: the two frameworks sum the q.k products in other orders,
which moves single logits by a few 1e-5 and each softmax carries that on
(one decode step from the *same* cache already differs by ~3e-5; after a
prefill and two steps the logits differ by up to ~6e-4).  Greedy tokens
must be equal.
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
from repro.models import encdec as jencdec
from repro.models.sharding import make_rules
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, encdec, transformer

ARCH = "whisper-tiny"
RULES = make_rules(None, {})
SEQ, MAX_SEQ, STEPS = 7, 16, 2
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CACHE = ("k", "v", "cross_k", "cross_v")


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


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    jcfg, cfg = _cfgs(request.param)
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    return (jcfg, jp, cfg, *_port(cfg, jp))


def test_config_equals_the_reference():
    full_j, full = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(full_j)
    assert dataclasses.asdict(reduced_config(full)) == dataclasses.asdict(jreduced_config(full_j))
    assert (full.family, full.enc_layers, full.n_layers, full.enc_seq) == ("encdec", 4, 4, 1500)
    assert transformer.padded_dims(full) == (6, 6, 51968)
    assert reduced_config(full).enc_seq == 16


def test_params_from_reference_keeps_bits_with_unequal_depths():
    """Each stacked subtree is unstacked by its own layer count (3 encoder
    layers, 2 decoder layers here), bit for bit; a count that does not
    match the config is refused."""
    jcfg, cfg = _cfgs("bfloat16", enc_layers=3)
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    ref = jax.tree.map(np.asarray, jp)
    m, params = _port(cfg, jp)
    sd = params.state_dict()
    assert set(params_from_reference(cfg, ref)) == set(sd)
    assert len(sd) == 9 * 3 + 14 * 2 + 4  # per layer; embed, enc_norm, final_norm, head
    same = lambda t, a: np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
    for stack, n in (("enc_blocks", 3), ("dec_blocks", 2)):
        for i in range(n):
            for group, sub in ref[stack].items():
                if isinstance(sub, dict):
                    for name, a in sub.items():
                        assert same(sd[f"{stack}.{i}.{group}.{name}"], a[i]), (stack, i, name)
                else:
                    assert same(sd[f"{stack}.{i}.{group}"], sub[i]), (stack, i, group)
    assert same(sd["enc_norm"], ref["enc_norm"]) and same(sd["head"], ref["head"])
    assert len(params.enc_blocks) == 3 and len(params.dec_blocks) == 2
    with pytest.raises(ValueError, match="enc_layers=2"):
        params_from_reference(dataclasses.replace(cfg, enc_layers=2), ref)


def _frames(cfg, seed=2):
    return np.random.default_rng(seed).normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_encode_matches_reference(pair, use_pallas):
    """The encoder's output: float32 at 1e-4; bf16 (two layers) no farther
    from the reference's float32 encoder than 3x the reference's bf16 one."""
    jcfg, jp, cfg, _, params = pair
    fr = _frames(cfg)
    want = jencdec.encode(jp, jnp.asarray(fr), jcfg, RULES, use_pallas)
    got = encdec.encode(params, torch.from_numpy(fr), cfg)
    assert got.dtype == DT[cfg.dtype][1] and tuple(got.shape) == fr.shape
    if cfg.dtype == "float32":
        _close(got, want, 1e-4, 1e-4)
        return
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    truth = jencdec.encode(jbuild_model(jcfg32).init(jax.random.key(0)), jnp.asarray(fr),
                           jcfg32, RULES)
    assert _rel(got, truth) <= 3 * _rel(want, truth), (_rel(got, truth), _rel(want, truth))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, size=(2, SEQ)).astype(np.int32),
            "frames": _frames(cfg, seed + 2)}


def _run(prefill, decode, batch):
    """Prefill, then STEPS decode steps fed the prompt's first tokens:
    (logits per step, the cache after the prefill, the last cache)."""
    logits, cache = prefill(batch)
    after_prefill = {k: (np.array(_np(v)) if hasattr(v, "shape") and v.ndim else int(v))
                     for k, v in cache.items()}
    out = [logits]
    for t in range(STEPS):
        logits, cache = decode(batch["tokens"][:, t:t + 1], cache)
        out.append(logits)
    return out, after_prefill, cache


def _jax_run(jm, jp, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return _run(lambda b: jm.prefill(jp, jbatch, MAX_SEQ),
                lambda t, c: jm.decode_step(jp, jnp.asarray(t), c), batch)


@pytest.fixture(scope="module")
def ref32():
    jcfg, _ = _cfgs("float32")
    jm = jbuild_model(jcfg)
    return _jax_run(jm, jm.init(jax.random.key(0)), _batch(jcfg))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_match_reference(pair, ref32, use_pallas):
    """Prefill logits, every cache field (self and cross K/V, the index),
    then decode steps."""
    jcfg, jp, cfg, m, params = pair
    jm = jbuild_model(jcfg, use_pallas=use_pallas)
    batch = _batch(cfg)
    want, jc0, jc = _jax_run(jm, jp, batch)
    got, c0, c = _run(lambda b: m.prefill(params, b, MAX_SEQ),
                      lambda t, c_: m.decode_step(params, t, c_), batch)
    assert set(c0) == set(jc0) == set(CACHE) | {"index"}
    assert c0["index"] == jc0["index"] == SEQ and c["index"] == int(jc["index"]) == SEQ + STEPS
    empty, jempty = m.init_cache(2, MAX_SEQ), jm.init_cache(2, MAX_SEQ)
    for key in CACHE:
        assert c0[key].shape == tuple(empty[key].shape) == jc[key].shape, key
        assert str(empty[key].dtype).split(".")[-1] == str(jempty[key].dtype), key
        assert c[key].dtype == DT[cfg.dtype][1]
    assert tuple(got[0].shape) == (2, 1, cfg.vocab_padded(16))
    if cfg.dtype == "float32":
        for g, w in zip(got, want):
            _close(g, w, 1e-3, 1e-3)
        for key in CACHE:
            _close(c0[key], jc0[key], 1e-3, 1e-3)
            _close(c[key], jc[key], 1e-3, 1e-3)
        return
    truth, truth_c0, truth_c = ref32
    pairs = list(zip(got, want, truth))
    pairs += [(c0[k], jc0[k], truth_c0[k]) for k in CACHE]
    pairs += [(c[k], jc[k], truth_c[k]) for k in ("k", "v")]
    for g, w, t in pairs:
        assert _rel(g, t) <= 3 * _rel(w, t), (_rel(g, t), _rel(w, t))


def test_greedy_tokens_match_reference():
    """Float32, through ``Model.prefill``/``decode_step`` (the reference's
    engine cannot serve enc-dec: it passes no frames): 10 greedy tokens a
    lane, each fed back, equal to the reference's."""
    jcfg, cfg = _cfgs("float32")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    m, params = _port(cfg, jp)

    def greedy(prefill, decode, batch):
        logits, cache = prefill(batch)
        out = []
        for _ in range(10):
            tok = np.asarray(_np(logits)[:, -1, :cfg.vocab].argmax(-1), np.int32)[:, None]
            out.append(tok[:, 0])
            logits, cache = decode(tok, cache)
        return np.stack(out, 1)

    batch = _batch(cfg, seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = greedy(lambda b: jm.prefill(jp, jbatch, MAX_SEQ + 4),
                  lambda t, c: jm.decode_step(jp, jnp.asarray(t), c), batch)
    got = greedy(lambda b: m.prefill(params, b, MAX_SEQ + 4),
                 lambda t, c: m.decode_step(params, t, c), batch)
    np.testing.assert_array_equal(got, want)


def test_prefill_without_frames_raises(pair):
    """The reference's prefill raises ``KeyError`` on a batch without
    ``frames``; the port raises ``ValueError`` naming them, and so does its
    launcher, whose engine passes only tokens (as the reference's does)."""
    _, _, cfg, m, params = pair
    with pytest.raises(ValueError, match="frames"):
        m.prefill(params, {"tokens": _batch(cfg)["tokens"]}, MAX_SEQ)
    with pytest.raises(ValueError, match="frames"):
        launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "1",
                           "--slots", "1", "--max-new", "2", "--prompt-len", "4",
                           "--max-seq", "8"])
