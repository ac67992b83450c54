"""The port's sharded path on 8 gloo ranks on the CPU, held to the JAX
package's own distributed checks (``tests/test_distributed.py``) at their
tolerances, and to the port's unsharded path.

One spawn of 8 ranks runs every check for the file
(``torch_mesh_checks.rank_checks``, a module that imports no ``jax``).
Every rank draws the port's weights at seed 0; the reference's numbers
are computed here, in the test's process on one device, from the same
weights carried across (``convert.params_to_reference``), while the
ranks run.

  * a train step: one AdamW step of reduced qwen3-32b on (2, 2, 2)
    (seq 16, batch 8): loss within 2e-3 and the first leaf within 3e-2
    of the JAX single-device step, and of the port's unsharded step;
  * MoE losses: reduced kimi-k2-1t-a32b (ep) and grok-1-314b (tp) on
    (2, 2, 2) within 2e-2 of the reference's; and, with no aux loss and
    no dropped tokens (where the per-shard capacity cannot change the
    function), float32 gradients of every weight within a relative 1e-4
    of the unsharded port's: the all-to-all, gather and psum backwards;
  * decode: reduced qwen3-32b prefill and one decode step on (2, 2, 2),
    the logits within 8e-2 of the reference's and of the port's
    unsharded run (the step's tokens drawn, not the prefill's argmax, so
    that the ranks need no reference output to start);
  * checkpoint reshard: reduced minitron-8b saved from (2, 2, 2),
    restored onto (4, 2) ("data", "model") with the specs' shardings:
    every leaf bit-equal and placed as the specs say;
  * beyond the reference's four: reduced qwen3-32b's loss on a (2, 4)
    ("data", "model") mesh, where each shard holds one query head of a
    two-head group, so two shards read one kv head; reduced qwen2-vl-2b's
    loss with images and M-RoPE positions on (2, 2, 2); each within 2e-3
    of the unsharded port, and the (2, 4) float32 gradients within a
    relative 1e-4 (the kv heads' partial gradients summed);
  * the sharded weight update: a float32 AdamW step of reduced qwen3-32b
    with 2 microbatches on (2, 2, 2) and on (2, 4), against the unsharded
    port's: the grad norm (the partial gradients reduced once, the norm
    summed over the shards, above the clip's 1), AdamW's m and v of every
    leaf (the reduced, clipped gradient and its square) within a relative
    1e-4, and every weight's update (new minus old, gathered) within 1e-4
    of its largest plus the new weight's float32 rounding, where the
    first step is well conditioned (see ``torch_mesh_checks._step_rel``:
    fewer than one element in a hundred is left out).
"""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_model as jbuild_model
from repro.optim import make_optimizer as jmake_optimizer
from repro.train import make_train_step as jmake_train_step
from repro_torch.comm import torchcoll
from torch_mesh_checks import FIELDS, rank_checks

N_RANKS = 8


def _jax_tree(cfg_name: str) -> tuple:
    """The port's weights at seed 0 (what every rank draws) as the
    reference's param tree of jnp arrays, and the reference's reduced
    config and model."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import params_to_reference
    from repro_torch.models import build_model

    cfg = reduced_config(get_config(cfg_name))
    tree = params_to_reference(cfg, build_model(cfg, device="cpu").init(0))
    jcfg = jreduced_config(jget_config(cfg_name))
    params = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jcfg.dtype), tree)
    return jcfg, jbuild_model(jcfg), params


def _reference(inputs: dict) -> dict:
    """The reference's numbers on one device, from the ranks' weights (its
    own test's checks)."""
    r = {}
    cfg, m0, params = _jax_tree("qwen3-32b")
    opt = jmake_optimizer("adamw", lr=1e-3, total_steps=10, warmup=1)
    st0 = {"params": params, "opt_state": opt.init(params), "step": jnp.zeros((), jnp.int32)}
    batch = JSyntheticLM(cfg, JDataConfig(seq_len=16, global_batch=8, seed=0)).batch(0)
    st0b, met0 = jax.jit(jmake_train_step(m0, opt))(st0, batch)
    r["train_loss"] = float(met0["loss"])
    r["train_leaf"] = np.asarray(jax.tree.leaves(st0b["params"])[0], np.float32)
    toks = jnp.asarray(inputs["decode_tokens"], jnp.int32)
    _, cache0 = m0.prefill(params, {"tokens": toks}, 32)
    step_tok = jnp.asarray(inputs["decode_step_tok"], jnp.int32)
    l0, _ = m0.decode_step(params, step_tok, cache0)
    r["decode"] = np.asarray(l0[:, 0, :cfg.vocab], np.float32)
    for arch, key in (("kimi-k2-1t-a32b", "kimi"), ("grok-1-314b", "grok")):
        mcfg, mm, mparams = _jax_tree(arch)
        b = JSyntheticLM(mcfg, JDataConfig(seq_len=16, global_batch=8, seed=0)).batch(0)
        r[f"moe_{key}"] = float(jax.jit(mm.loss)(mparams, b)[0])
    return r


@pytest.fixture(scope="module")
def run():
    """(the reference's numbers, FIELDS from the 8 gloo ranks, each a stack
    of the ranks' values): the ranks run in a thread of this process's
    while the reference computes here."""
    rng = np.random.default_rng(1)
    inputs = {"decode_tokens": rng.integers(0, 256, (4, 8)),
              "decode_step_tok": rng.integers(0, 256, (4, 1))}
    got: dict = {}

    def ranks():
        try:
            got["out"] = torchcoll.run_on_axis(functools.partial(rank_checks, inputs=inputs),
                                               N_RANKS, np.arange(N_RANKS))
        except BaseException as e:  # re-raised in the test's thread
            got["error"] = e

    t = threading.Thread(target=ranks)
    t.start()
    try:
        r = _reference(inputs)
    finally:
        t.join()
    if "error" in got:
        raise got["error"]
    return r, dict(zip(FIELDS, got["out"]))


def _same_on_every_rank(t):
    for i in range(1, N_RANKS):
        assert torch.equal(t[0], t[i]), f"rank {i} differs from rank 0"
    return t[0]


def test_sharded_train_step_matches_single_device(run):
    r, ranks = run
    loss_mesh = float(_same_on_every_rank(ranks["train_loss_mesh"]))
    loss_port = float(ranks["train_loss_port"][0])
    assert abs(r["train_loss"] - loss_mesh) < 2e-3, (r["train_loss"], loss_mesh)
    assert abs(loss_port - loss_mesh) < 2e-3, (loss_port, loss_mesh)
    leaf = _same_on_every_rank(ranks["train_leaf_mesh"]).numpy()
    np.testing.assert_allclose(r["train_leaf"], leaf, atol=3e-2)
    np.testing.assert_allclose(ranks["train_leaf_port"][0].numpy(), leaf, atol=3e-2)


@pytest.mark.parametrize("key", ["kimi", "grok"])
def test_sharded_moe_matches_single_device(run, key):
    r, ranks = run
    loss = float(_same_on_every_rank(ranks[f"moe_{key}_mesh"]))
    assert abs(r[f"moe_{key}"] - loss) < 2e-2, (key, r[f"moe_{key}"], loss)
    assert abs(float(ranks[f"moe_{key}_port"][0]) - loss) < 2e-2
    assert float(ranks[f"moe_{key}_grad_rel"].max()) < 1e-4


def test_sharded_decode_matches_single_device(run):
    r, ranks = run
    logits = _same_on_every_rank(ranks["decode_mesh"]).numpy()
    np.testing.assert_allclose(r["decode"], logits, atol=8e-2)
    np.testing.assert_allclose(ranks["decode_port"][0].numpy(), logits, atol=8e-2)


def test_checkpoint_reshard_across_meshes(run):
    _, ranks = run
    assert ranks["reshard_equal"].min() == 1.0
    assert ranks["reshard_placed"].min() == 1.0
    assert ranks["reshard_step"].min() == 7.0


def test_shared_kv_head_on_a_wide_model_axis(run):
    _, ranks = run
    loss = float(_same_on_every_rank(ranks["loss_24_mesh"]))
    assert abs(float(ranks["loss_24_port"][0]) - loss) < 2e-3
    assert float(ranks["grad_24_rel"].max()) < 1e-4


def test_sharded_vlm_with_images(run):
    _, ranks = run
    loss = float(_same_on_every_rank(ranks["vlm_mesh"]))
    assert abs(float(ranks["vlm_port"][0]) - loss) < 2e-3


@pytest.mark.parametrize("mesh", ["222", "24"])
def test_sharded_update_matches_single_device(run, mesh):
    _, ranks = run
    norm = float(_same_on_every_rank(ranks[f"step_{mesh}_norm"]))
    assert norm > 1.0, norm  # the clip scales the gradients
    assert float(ranks[f"step_{mesh}_norm_rel"].max()) < 1e-4
    assert float(ranks[f"step_{mesh}_moments_rel"].max()) < 1e-4
    # in units of 1e-4 of the largest update plus the new weight's rounding
    assert float(ranks[f"step_{mesh}_update_err"].max()) < 1.0
    assert float(ranks[f"step_{mesh}_ill"].max()) < 1e-2  # a share of the elements
