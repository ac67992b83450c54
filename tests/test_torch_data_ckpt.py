"""The port's data pipeline and checkpoints against the JAX package's:
``SyntheticLM`` batches bit for bit for every family (the bf16 image
embeddings and frames as their bits), its state and host shards; a
checkpoint written by either package restores into the other, with
byte-equal ``.bin`` files for the same tree, crash-mid-save safety, the
bf16 round trip and ``latest_step``."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference, params_to_reference
from repro_torch.data import DataConfig, SyntheticLM, make_batch
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.train import Trainer

FAMILIES = ["qwen3-32b", "grok-1-314b", "qwen2-vl-2b", "mamba2-2.7b", "zamba2-2.7b",
            "whisper-tiny"]


def _bits(x):
    """An array's or tensor's bits as a numpy array (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("arch", FAMILIES)
def test_batches_equal_the_reference_bit_for_bit(arch):
    jcfg, cfg = jreduced_config(jget_config(arch)), reduced_config(get_config(arch))
    if cfg.family == "vlm":  # the full config's image count, so the float64 draws are many
        jcfg = dataclasses.replace(jcfg, img_tokens=256)
        cfg = dataclasses.replace(cfg, img_tokens=256)
    for i in (0, 3):
        want = JSyntheticLM(jcfg, JDataConfig(seq_len=300, global_batch=4, seed=5)).batch(i)
        got = SyntheticLM(cfg, DataConfig(seq_len=300, global_batch=4, seed=5)).batch(i)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            assert tuple(got[k].shape) == w.shape and str(got[k].dtype)[6:] == str(w.dtype), k
            assert np.array_equal(_bits(got[k]), _bits(w)), (arch, i, k)


def test_data_state_skip_ahead_and_host_shards():
    jcfg, cfg = jreduced_config(jget_config("qwen3-32b")), reduced_config(get_config("qwen3-32b"))
    d = SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=8, seed=3))
    first = [d.batch() for _ in range(3)]
    assert d.state() == {"step": 3}
    d2 = SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=8, seed=3))
    d2.restore({"step": 2})
    assert torch.equal(d2.batch()["tokens"], first[2]["tokens"]) and d2.step == 3
    assert torch.equal(d2.batch(0)["tokens"], first[0]["tokens"]) and d2.step == 3
    for host in (0, 1):
        dc = dict(seq_len=16, global_batch=8, seed=3, host_id=host, n_hosts=2)
        got = SyntheticLM(cfg, DataConfig(**dc)).batch(1)
        want = JSyntheticLM(jcfg, JDataConfig(**dc)).batch(1)
        assert got["tokens"].shape == (4, 16)
        assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    h0 = SyntheticLM(cfg, DataConfig(16, 8, 3, 0, 2)).batch(0)["tokens"]
    h1 = SyntheticLM(cfg, DataConfig(16, 8, 3, 1, 2)).batch(0)["tokens"]
    assert not torch.equal(h0, h1)
    with pytest.raises(ValueError, match="n_hosts"):
        SyntheticLM(cfg, DataConfig(16, 6, 0, 0, 4))
    assert torch.equal(make_batch(cfg, 2, 8, seed=1)["labels"],
                       SyntheticLM(cfg, DataConfig(8, 2, 1)).batch(0)["labels"])


def _trainers(tmp, arch="qwen3-32b", dtype="bfloat16", every=2):
    """A JAX and a port Trainer on the same config with the same weights."""
    jcfg = dataclasses.replace(jreduced_config(jget_config(arch)), dtype=dtype)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    jt = JTrainer(model=jbuild_model(jcfg),
                  opt=jmake_optimizer(jcfg.optimizer, lr=3e-3, total_steps=50, warmup=2),
                  data=JSyntheticLM(jcfg, JDataConfig(seq_len=16, global_batch=4, seed=0)),
                  ckpt_dir=os.path.join(tmp, "jax"), ckpt_every=every)
    jt.init(0)
    pt = Trainer(model=build_model(cfg, device="cpu"),
                 opt=make_optimizer(cfg.optimizer, lr=3e-3, total_steps=50, warmup=2),
                 data=SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=4, seed=0)),
                 ckpt_dir=os.path.join(tmp, "port"), ckpt_every=every)
    pt.init(0)
    pt.state["params"].load_state_dict(
        params_from_reference(cfg, jax.tree.map(np.asarray, jt.state["params"])))
    return jt, pt


@pytest.mark.parametrize("arch", ["qwen3-32b", "grok-1-314b"])
def test_same_tree_writes_byte_equal_files(tmp_path, arch):
    """The same state (the reference's weights, zero optimizer state, step
    0) saved by both packages: the same manifest and byte-equal .bin
    files."""
    jt, pt = _trainers(str(tmp_path), arch)
    jckpt.save(str(tmp_path / "j"), 0, jt.state, extras={"data": {"step": 0}})
    ckpt.save(str(tmp_path / "p"), 0, pt.reference_tree(), extras={"data": {"step": 0}})
    mj = json.load(open(tmp_path / "j" / "step_000000000" / "MANIFEST.json"))
    mp = json.load(open(tmp_path / "p" / "step_000000000" / "MANIFEST.json"))
    assert mj == mp
    assert list(mj["leaves"]) == list(mp["leaves"])  # the reference's order too
    for meta in mj["leaves"].values():
        a = open(tmp_path / "j" / "step_000000000" / meta["file"], "rb").read()
        b = open(tmp_path / "p" / "step_000000000" / meta["file"], "rb").read()
        assert a == b, meta["file"]


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """The JAX Trainer trains 2 steps and checkpoints; a fresh port Trainer
    restores it and continues with the reference's own losses."""
    jt, _ = _trainers(str(tmp_path), dtype="float32")
    jt.train(2, log_every=0)
    want = jt.train(2, log_every=0)
    cfg = dataclasses.replace(reduced_config(get_config("qwen3-32b")), dtype="float32")
    pt = Trainer(model=build_model(cfg, device="cpu"),
                 opt=make_optimizer(cfg.optimizer, lr=3e-3, total_steps=50, warmup=2),
                 data=SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=4, seed=0)),
                 ckpt_dir=str(tmp_path / "jax"))
    assert ckpt.latest_step(str(tmp_path / "jax")) == 4
    jckpt_steps = jckpt.list_steps(str(tmp_path / "jax"))
    assert ckpt.list_steps(str(tmp_path / "jax")) == jckpt_steps == [2, 4]
    # restore step 2 (drop the later one) and continue
    os.remove(tmp_path / "jax" / "LATEST")
    import shutil

    shutil.rmtree(tmp_path / "jax" / "step_000000004")
    assert pt.restore() and pt.state["step"] == 2 and pt.data.step == 2
    got = pt.train(2, log_every=0)
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-32b", "grok-1-314b"])
def test_port_checkpoint_restores_into_the_reference(tmp_path, arch):
    """The port trains a step and saves; the JAX package's
    ``ckpt.restore(like=...)`` reads it back leaf for leaf (bf16 as bf16)."""
    jt, pt = _trainers(str(tmp_path), arch)
    pt.train(1, log_every=0)
    pt.save()
    tree, step, extras = jckpt.restore(str(tmp_path / "port"), like=jt.state)
    assert step == 1 and extras == {"data": {"step": 1}} and int(tree["step"]) == 1
    mine = pt.reference_tree()
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                 jax.tree_util.tree_flatten_with_path(
                                     jax.tree.map(lambda x: np.asarray(
                                         x.float() if isinstance(x, torch.Tensor) else x,
                                         np.float32), mine))[0]):
        assert np.array_equal(np.asarray(a, np.float32), b), path
    assert tree["params"]["embed"].dtype == jnp.bfloat16


def test_atomic_save_crash_safety(tmp_path):
    """A torn save never shadows the previous good checkpoint."""
    tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 3))}}
    ckpt.save(str(tmp_path), 1, tree)
    os.makedirs(tmp_path / ".tmp_save_crash", exist_ok=True)
    with open(tmp_path / ".tmp_save_crash" / "a.bin", "wb") as f:
        f.write(b"garbage")
    restored, step, _ = ckpt.restore(str(tmp_path), like=tree)
    assert step == 1 and torch.equal(restored["a"], torch.arange(10))

    class Boom(RuntimeError):
        pass

    class Bad:  # a leaf whose bytes cannot be taken: the save fails midway
        def __array__(self, *a, **k):
            raise Boom()

    with pytest.raises(Boom):
        ckpt.save(str(tmp_path), 2, {"a": torch.zeros(2), "z": Bad()})
    assert ckpt.latest_step(str(tmp_path)) == 1 and ckpt.list_steps(str(tmp_path)) == [1]
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_save_") and d != ".tmp_save_crash"]


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32))
    tree = {"w": w.to(torch.bfloat16), "s": np.asarray(3, np.int32)}
    ckpt.save(str(tmp_path), 3, tree)
    meta = json.load(open(tmp_path / "step_000000003" / "MANIFEST.json"))["leaves"]
    assert meta["w"] == {"file": "w.bin", "shape": [4, 5], "dtype": "bfloat16"}
    assert meta["s"]["dtype"] == "int32" and meta["s"]["shape"] == []
    out, step, _ = ckpt.restore(str(tmp_path))
    assert step == 3 and out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], tree["w"])
    # the JAX package reads the same bytes as bf16
    jout, _, _ = jckpt.restore(str(tmp_path), like={"w": jnp.zeros((4, 5), jnp.bfloat16),
                                                     "s": jnp.zeros((), jnp.int32)})
    assert np.array_equal(np.asarray(jout["w"], np.float32), tree["w"].float().numpy())


def test_latest_step_and_missing_leaves(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"))
    for s in (3, 1, 2):
        ckpt.save(str(tmp_path), s, {"x": torch.full((2,), float(s))})
    assert ckpt.latest_step(str(tmp_path)) == 2  # LATEST: the last save
    os.remove(tmp_path / "LATEST")
    assert ckpt.latest_step(str(tmp_path)) == 3 and ckpt.list_steps(str(tmp_path)) == [1, 2, 3]
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(str(tmp_path), like={"x": 0, "y": 0})


def test_params_to_reference_inverts_params_from_reference():
    cfg = reduced_config(get_config("whisper-tiny"))
    jp = jbuild_model(jreduced_config(jget_config("whisper-tiny"))).init(jax.random.key(0))
    params = build_model(cfg, device="cpu").init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))
    back = params_to_reference(cfg, params)
    ja = jax.tree_util.tree_flatten_with_path(jp)[0]
    pa = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in ja] == [p for p, _ in pa]
    for (_, a), (_, b) in zip(ja, pa):
        assert np.array_equal(_bits(a), _bits(b))
