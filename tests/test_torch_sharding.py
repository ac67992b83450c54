"""The port's logical-axis rules and state specs (``repro_torch.models.
sharding``, ``repro_torch.launch.specs``) against the JAX package's, in
one process (no spawned ranks):

  * ``DEFAULT_RULES`` equals the reference's table;
  * every config's ``param_axes()`` and ``cache_axes()`` equal the
    reference model's, and ``spec`` gives the reference's PartitionSpec
    entries for every parameter at its full-size shape (from
    ``jax.eval_shape``) on the (16, 16), (2, 16, 16), (2, 2, 2) and (4, 2)
    meshes.  Both packages' rules read only a mesh's axis names and shape,
    so a stand-in with those serves for the 512-rank mesh;
  * ``opt_state_shardings`` (adamw, adafactor: its factored statistics
    drop the factored dim) and ``cache_shardings``, which the reference
    computes on a real mesh: one ``devices8`` subprocess prints its specs
    for (2, 2, 2) and (4, 2);
  * a constraint that does not divide is dropped (whisper-tiny's 6 heads
    on a 16-way axis); ``shard`` raises on a rank mismatch;
  * ``specs.param_shapes`` (an init on the meta device) equals
    ``jax.eval_shape``'s shapes and dtypes for every config;
  * the MoE per-shard body (``moe._moe_shard``, no collectives) agrees in
    float32 within 1e-5 with the reference's ``_moe_shard(..., None,
    None)`` on the same local inputs, in ep and tp mode.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models import sharding as jsharding
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import specs as S
from repro_torch.models import build_model, moe, sharding
from repro_torch.models.zoo import Model

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((4, 2), ("data", "model"))]


class _Shape(dict):
    """A mesh shape read both ways: by axis name (the reference) and by
    mesh dim (``DeviceMesh.shape``, the port)."""

    def __getitem__(self, k):
        return list(self.values())[k] if isinstance(k, int) else dict.__getitem__(self, k)


class _Mesh:
    """A stand-in mesh: axis names and shape, no devices."""

    def __init__(self, shape, axes):
        self.axis_names = self.mesh_dim_names = tuple(axes)
        self.shape = _Shape(zip(axes, shape))


def _leaves(axes, shapes, path=""):
    """(path, axes, shape) of each leaf of matching axes and shapes trees."""
    if isinstance(axes, dict):
        for k in axes:
            yield from _leaves(axes[k], shapes[k], f"{path}/{k}")
    else:
        yield path, tuple(axes), tuple(shapes.shape)


def test_default_rules_equal_the_reference():
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tables_equal_the_reference(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jm = jbuild_model(jcfg)
    port = build_model(cfg, device="cpu")
    assert port.param_axes() == jm.param_axes()
    assert port.cache_axes() == jm.cache_axes()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    leaves = list(_leaves(jm.param_axes(), shapes))
    assert leaves
    for shape, axes in MESHES:
        mesh = _Mesh(shape, axes)
        jr = jsharding.make_rules(mesh, jcfg.sharding_overrides)
        pr = sharding.make_rules(mesh, cfg.sharding_overrides)
        for path, ax, dims in leaves:
            assert pr.spec(*ax, dims=dims) == tuple(jr.spec(*ax, dims=dims)), (arch, shape, path)
            assert pr.spec(*ax) == tuple(jr.spec(*ax)), (arch, shape, path)
        assert pr.data_shards() == jr.data_shards() and pr.model_shards() == jr.model_shards()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_equal_eval_shape(arch):
    jm = jbuild_model(jget_config(arch))
    want = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    got = S.param_shapes(build_model(get_config(arch), device="cpu"))
    flat_want = {p: (s, str(_at(want, p).dtype)) for p, _, s in _leaves(jm.param_axes(), want)}
    flat_got = {p: (s, str(_at(got, p).dtype).replace("torch.", ""))
                for p, _, s in _leaves(jm.param_axes(), got)}
    assert flat_got == flat_want


def _at(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def test_constraints_that_do_not_divide_are_dropped():
    mesh = _Mesh((16, 16), ("data", "model"))
    rules = sharding.make_rules(mesh, {})
    assert rules.spec("heads", dims=(6,)) == (None,)
    assert rules.spec("heads", dims=(64,)) == ("model",)
    assert rules.spec("batch", "seq", dims=(8, 1024)) == (None, None)
    assert rules.spec("batch", dims=(32,)) == ("data",)
    multi = sharding.make_rules(_Mesh((2, 16, 16), ("pod", "data", "model")), {})
    assert multi.spec("batch", dims=(64,)) == (("pod", "data"),)
    assert multi.spec("batch", dims=(16,)) == (None,)
    # whisper-tiny: 6 heads, and its overrides keep heads whole
    w = get_config("whisper-tiny")
    wr = sharding.make_rules(mesh, w.sharding_overrides)
    assert wr.spec("heads", "w_heads", dims=(6, 6)) == (None, None)
    assert tuple(jsharding.make_rules(mesh, {}).spec("heads", dims=(6,))) == (None,)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    rules = sharding.make_rules(_Mesh((2, 2, 2), ("pod", "data", "model")), {})
    assert rules.placements("batch", None, "vocab", dims=(8, 4, 256)) == [
        Shard(0), Shard(0), Shard(2)]
    assert rules.placements("w_embed", "w_kv_heads", None, dims=(64, 2, 16)) == [
        Replicate(), Shard(0), Replicate()]
    named = sharding.NamedSharding(rules.mesh, (None, "data", "model"))
    assert named.layer().spec == ("data", "model")
    with pytest.raises(ValueError, match="layer axis"):
        sharding.NamedSharding(rules.mesh, ("data", None)).layer()


def test_shard_raises_on_a_rank_mismatch():
    rules = sharding.make_rules(_Mesh((2, 2, 2), ("pod", "data", "model")), {})
    with pytest.raises(ValueError, match="2 names for rank-3"):
        rules.shard(torch.zeros(2, 2, 2), "batch", "seq")
    x = torch.zeros(3)
    assert sharding.make_rules(None, {}).shard(x, "batch", "seq") is x  # no mesh: no-op


# ------------------------------------------------------------------------------
# Optimizer-state and cache specs: the reference computes them on a real mesh
# ------------------------------------------------------------------------------

_SPEC_ARCHS = [("qwen3-32b", "adamw"), ("kimi-k2-1t-a32b", "adafactor"),
               ("grok-1-314b", "adafactor")]


@pytest.fixture(scope="module")
def reference_specs(devices8):
    """The reference's opt_state and cache PartitionSpecs on (2, 2, 2) and
    (4, 2), from one 8-device subprocess."""
    out = devices8(f"""
import json, jax
from repro.configs import get_config
from repro.models import build_model
from repro.launch.mesh import make_test_mesh
from repro.launch import specs as S

def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {{}}
        for k, v in tree.items():
            out.update(flat(v, path + "/" + k))
        return out
    return {{path: [list(e) if isinstance(e, tuple) else e for e in tree.spec]}}

res = {{}}
for shape, axes in [((2, 2, 2), ("pod", "data", "model")), ((4, 2), ("data", "model"))]:
    mesh = make_test_mesh(shape, axes)
    for arch, opt in {_SPEC_ARCHS!r}:
        m = build_model(get_config(arch), mesh=mesh)
        res[f"{{shape}}|{{arch}}|opt"] = flat(S.opt_state_shardings(m, opt))
    m = build_model(get_config("qwen3-32b"), mesh=mesh)
    cache = jax.eval_shape(lambda: m.init_cache(8, 1024))
    res[f"{{shape}}|cache"] = flat(S.cache_shardings(m, cache))
    res[f"{{shape}}|batch"] = flat(S.batch_shardings(m, {{
        "tokens": jax.ShapeDtypeStruct((8, 16), "int32"),
        "positions": jax.ShapeDtypeStruct((3, 8, 16), "int32"),
        "img_embeds": jax.ShapeDtypeStruct((8, 4, 64), "bfloat16")}}))
print("SPECS" + json.dumps(res))
""")
    line = next(ln for ln in out.splitlines() if ln.startswith("SPECS"))
    return json.loads(line[len("SPECS"):])


def _port_flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, path + "/" + k))
        return out
    return {path: [list(e) if isinstance(e, tuple) else e for e in tree.spec]}


@pytest.mark.parametrize("shape,axes", MESHES[2:])
def test_state_specs_equal_the_reference(reference_specs, shape, axes):
    mesh = _Mesh(shape, axes)
    for arch, opt in _SPEC_ARCHS:
        cfg = get_config(arch)
        m = Model(cfg=cfg, device=torch.device("cpu"),
                  rules=sharding.make_rules(mesh, cfg.sharding_overrides))
        got = _port_flat(S.opt_state_shardings(m, opt))
        assert got == reference_specs[f"{shape}|{arch}|opt"], (shape, arch)
    cfg = get_config("qwen3-32b")
    m = Model(cfg=cfg, device=torch.device("cpu"), rules=sharding.make_rules(mesh, {}))
    cache = S._cache_shapes(m, 8, 1024)
    assert _port_flat(S.cache_shardings(m, cache)) == reference_specs[f"{shape}|cache"]
    batch = {"tokens": torch.empty(8, 16), "positions": torch.empty(3, 8, 16),
             "img_embeds": torch.empty(8, 4, 64)}
    assert _port_flat(S.batch_shardings(m, batch)) == reference_specs[f"{shape}|batch"]


# ------------------------------------------------------------------------------
# The MoE per-shard body
# ------------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "grok-1-314b"])
def test_moe_shard_body_matches_the_reference(arch):
    jm = jreduced_config(jget_config(arch)).moe
    m = reduced_config(get_config(arch)).moe
    d, E, fe = 64, m.n_experts, m.d_ff_expert
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    router = (rng.normal(size=(d, E)) * 0.5).astype(np.float32)
    w1, w3 = (rng.normal(size=(E, d, fe)).astype(np.float32) / 8 for _ in range(2))
    w2 = rng.normal(size=(E, fe, d)).astype(np.float32) / 6
    jy, jaux = jmoe._moe_shard(*(jnp.asarray(a) for a in (x, router, w1, w3, w2)), jm,
                               None, None)
    y, aux = moe._moe_shard(*(torch.from_numpy(a) for a in (x, router, w1, w3, w2)), m)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=1e-5)
