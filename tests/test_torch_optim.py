"""The port's optimizers against the JAX package's: AdamW and Adafactor
updates of the same parameters, gradients and state, within 2 ulps in
float32 and 1 bf16 ulp in bf16 (the parameters and the fp32 state alike;
the two packages round ``pow`` and ``sqrt`` in other places; Adafactor's
float32 parameters within 4 ulps: its update divides by two statistics
that are means over a row, a column and the whole stacked leaf, which XLA
and PyTorch sum in other orders, a last-place difference each); the gradients' global norm stays under the clip there, so the
clip scales nothing and the update is held apart from the norm's sum,
which is held at a relative 1e-5), Adafactor also at a 16-layer config where the stacked 1-D
leaves factor across the layers; ``cosine_schedule``,
``clip_by_global_norm`` and ``global_norm``.  The port keeps its layers
unstacked, so its update walks the reference's leaves
(``convert.reference_leaves``) and keeps the state in the reference's
stacked tree."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced_config
from repro.models import build_model as jbuild_model
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference, reference_leaves
from repro_torch.models import build_model
from repro_torch.optim import optimizers as opt
from repro_torch.optim.optimizers import tree_get


def _setup(arch, dtype, grad_std=0.05, **kw):
    jcfg = dataclasses.replace(jreduced_config(jget_config(arch)), dtype=dtype, **kw)
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype, **kw)
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    m = build_model(cfg, device="cpu")
    params = m.init(0)
    params.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(7)
    # gradients in the parameters' dtype, as one microbatch gives them
    jg = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * grad_std, p.dtype), jp)
    return cfg, jp, params, jg, rng


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_grads(cfg, leaves, jg):
    sd = params_from_reference(cfg, jax.tree.map(np.asarray, jg))
    names = {id(t): n for n, t in leaves_named(leaves, cfg)}
    return [[sd[names[id(t)]].clone() for t in leaf.tensors] for leaf in leaves]


def leaves_named(leaves, cfg):
    for leaf in leaves:
        head, _, rest = leaf.path.partition("/")
        for i, t in enumerate(leaf.tensors):
            if leaf.stacked:
                yield f"{head}.{i}.{rest.replace('/', '.')}", t
            else:
                yield leaf.path.replace("/", "."), t


def _port_state(jstate):
    return jax.tree.map(lambda a: _t(a), jstate)


def _ulp(x, dtype):
    """The last place of |x| in ``dtype`` (float32 or bfloat16)."""
    mant = 23 if dtype == "float32" else 7
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(np.asarray(x, np.float64)), 1e-38)))
                   - mant)


def _ulps(a, b, dtype):
    """Distance of a from b in units of b's last place in ``dtype``."""
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / _ulp(b, dtype)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _check(got, want, dtype, limit, what, old=None):
    """``got`` within ``limit`` ulps of ``want``, counted at the largest
    magnitude of ``want``, of the value it was updated from (``old``) and of
    the step between them, the operands of the update's last subtraction:
    an update that nearly cancels its parameter lands on a value whose own
    last place is far below the operands' rounding."""
    got, want = _f32(got), _f32(want)
    if old is None:
        scale = want
    else:
        old = _f32(old)
        scale = np.maximum(np.maximum(np.abs(want), np.abs(old)), np.abs(want - old))
    diff = np.abs(got.astype(np.float64) - want)
    u = diff / _ulp(scale, dtype)
    assert u.max() <= limit, (what, float(u.max()))


def _rel(got, want, tol, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * abs(want), (what, got, want)


def _run(name, arch, dtype, step=3, **kw):
    # a global norm well under 1 (the clip's max_norm): the clip is the identity
    cfg, jp, params, jg, rng = _setup(arch, dtype, grad_std=1e-4, **kw)
    make = {"adamw": (jopt.adamw, opt.adamw), "adafactor": (jopt.adafactor, opt.adafactor)}[name]
    sched = (jopt.cosine_schedule(3e-3, 2, 20), opt.cosine_schedule(3e-3, 2, 20))
    jo, po = make[0](lr=sched[0]), make[1](lr=sched[1])
    jstate = jo.init(jp)
    # a state as after a few steps: positive second moments, signed first ones
    jstate = jax.tree.map(lambda s: jnp.asarray(np.abs(rng.normal(size=s.shape)) * 1e-3
                                                if s.ndim else s, s.dtype), jstate)
    if name == "adamw":
        jstate["m"] = jax.tree.map(lambda s: jnp.asarray(rng.normal(size=s.shape) * 1e-2,
                                                         jnp.float32), jstate["m"])
    leaves = reference_leaves(cfg, params)
    state = _port_state(jstate)
    grads = _port_grads(cfg, leaves, jg)
    old_sd = {k: v.clone() for k, v in params.state_dict().items()}
    new_jp, new_js, jstats = jo.update(jg, jstate, jp, jnp.asarray(step, jnp.int32))
    stats = po.update(grads, state, leaves, step)
    assert float(jstats["grad_norm"]) < 1.0
    _rel(stats["grad_norm"], jstats["grad_norm"], 1e-5, "grad_norm")
    _check(stats["lr"], jstats["lr"], "float32", 2, "lr")
    want = params_from_reference(cfg, jax.tree.map(np.asarray, new_jp))
    sd = params.state_dict()
    limit = 1 if dtype == "bfloat16" else 4 if name == "adafactor" else 2
    for n in sd:
        _check(sd[n], want[n], dtype, limit, n, old=old_sd[n])
    flat_j = jax.tree_util.tree_flatten_with_path(new_js)[0]
    flat_old = dict((("/".join(str(p.key) for p in path)), a)
                    for path, a in jax.tree_util.tree_flatten_with_path(jstate)[0])
    for path, a in flat_j:
        key = "/".join(str(p.key) for p in path)
        _check(tree_get(state, key), a, "float32", 2, key, old=flat_old[key])
    return cfg, leaves, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-32b", "zamba2-2.7b"])
def test_adamw_update_matches_reference(arch, dtype):
    _run("adamw", arch, dtype)


def test_cosine_schedule_matches_reference():
    for base, warm, total in ((3e-4, 200, 10_000), (1e-3, 1, 8), (1e-3, 5, 5)):
        j = jopt.cosine_schedule(base, warm, total)
        p = opt.cosine_schedule(base, warm, total)
        steps = np.unique(np.concatenate([np.arange(0, min(total, 12) + 3),
                                          np.linspace(0, total + 2, 9).astype(int)]))
        got = np.array([float(p(torch.tensor(int(s), dtype=torch.int32))) for s in steps])
        want = np.array([float(j(jnp.asarray(s, jnp.int32))) for s in steps])
        # 2 ulps of the base rate: near the end the cosine's 1 + cos(pi t)
        # cancels, and the two packages' cos differ in their last place there
        assert (np.abs(got - want) / _ulp(base, "float32")).max() <= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    """The norm over every leaf (a sum over 10^5 squares in another order:
    a relative 1e-5), and each gradient scaled in fp32 and rounded back to
    its own dtype (bf16 stays bf16), in place: within a relative 2e-5 of
    the reference's in float32 (the scale carries the norm's rounding) and
    1 ulp in bf16."""
    cfg, jp, params, jg, _ = _setup("qwen3-32b", dtype)
    leaves = reference_leaves(cfg, params)
    grads = _port_grads(cfg, leaves, jg)
    jclipped, jnorm = jopt.clip_by_global_norm(jg, max_norm)
    clipped, norm = opt.clip_by_global_norm(grads, max_norm)
    _rel(norm, jnorm, 1e-5, "norm")
    _rel(opt.global_norm(grads), jopt.global_norm(jclipped), 1e-5, "clipped norm")
    want = params_from_reference(cfg, jax.tree.map(np.asarray, jclipped))
    names = [n for n, _ in leaves_named(leaves, cfg)]
    flat = [g for gs in clipped for g in gs]
    for n, g in zip(names, flat):
        assert g.dtype == getattr(torch, dtype)
        w = want[n].float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=0)
        else:
            _check(g, w, dtype, 1, n)


def test_make_optimizer_names():
    assert opt.make_optimizer("adamw").name == "adamw"
    assert opt.make_optimizer("adafactor").name == "adafactor"
    with pytest.raises(ValueError):
        opt.make_optimizer("sgd")
