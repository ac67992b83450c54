"""The rank side of ``tests/test_torch_distributed.py``: every check of the
port's sharded path on one gloo rank.  It imports ``torch`` and the port
only (no ``jax``), as each spawned rank imports this module."""
import dataclasses

import torch

# what each rank returns, in order
FIELDS = ("train_loss_mesh", "train_loss_port", "train_leaf_mesh", "train_leaf_port",
          "moe_kimi_mesh", "moe_kimi_port", "moe_grok_mesh", "moe_grok_port",
          "moe_kimi_grad_rel", "moe_grok_grad_rel",
          "decode_mesh", "decode_port",
          "reshard_equal", "reshard_placed", "reshard_step",
          "loss_24_mesh", "loss_24_port", "grad_24_rel",
          "vlm_mesh", "vlm_port",
          "step_222_norm_rel", "step_222_moments_rel", "step_222_update_err",
          "step_222_norm", "step_222_ill",
          "step_24_norm_rel", "step_24_moments_rel", "step_24_update_err",
          "step_24_norm", "step_24_ill")


def _grad_rel(cfg, mesh, batch):
    """Largest relative difference of any weight's float32 gradient, mesh
    against one device, from the same weights."""
    import torch as T

    from repro_torch.launch import specs as S
    from repro_torch.models import build_model

    m0, m1 = build_model(cfg, device="cpu"), build_model(cfg, mesh=mesh)
    p0 = m0.init(1).requires_grad_(True)
    p1 = m0.init(1)
    S.place_params(m1, p1)
    p1.requires_grad_(True)
    g0 = T.autograd.grad(m0.loss(p0, batch)[0], list(p0.parameters()))
    g1 = T.autograd.grad(m1.loss(p1, batch)[0], list(p1.parameters()))
    return max(float((a - b.full_tensor()).abs().max() / a.abs().max().clamp(min=1e-30))
               for a, b in zip(g0, g1))


def _full(t):
    return t.detach().full_tensor() if hasattr(t, "full_tensor") else t.detach()


# AdamW's b1 (``optimizers.adamw``), for the first step's bias correction
B1 = 0.9


def _rel(a, b) -> float:
    """Largest difference over the largest magnitude of ``b``."""
    return float((a - b).abs().max() / b.abs().max())


def _step_rel(cfg, mesh, batch):
    """One float32 AdamW step with 2 microbatches (the partial gradients
    summed on the local shards, reduced once, clipped by the global norm)
    on the mesh and on one device, from the same weights.  Returns the
    relative differences, mesh against one device, of the grad norm and of
    AdamW's m and v (the reduced, clipped gradient and its square: the
    largest over the leaves); the largest difference of any weight's
    update, new minus old, in units of its tolerance below, over the
    elements whose first step is well conditioned; the grad norm; and the
    share of the other elements.

    The update of an element is exact up to its new value's float32
    rounding (one ulp of a weight near 1 is 1e-4 of lr), so its tolerance
    is 1e-4 of the weight's largest update plus that rounding.  The first
    step moves an element by lr * g / (|g| + eps), a sign-like function of
    g: where |g| is a few eps, a rounding error of g (a sum in another
    order) moves it by a few percent of lr.  So the update is compared
    where g is 0 (the padded heads and vocabulary: weight decay alone) or
    |g| exceeds both 1e-6 and a thousandth of the weight's largest |g|:
    there an error of 1e-6 of the largest |g| moves it by at most 1e-5 of
    lr.  The gradient itself is held everywhere, through m and v."""
    from repro_torch.convert import reference_leaves
    from repro_torch.launch import specs as S
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.optimizers import tree_get
    from repro_torch.train import TrainState, make_train_step

    cfg = dataclasses.replace(cfg, dtype="float32")
    m0, m1 = build_model(cfg, device="cpu"), build_model(cfg, mesh=mesh)
    opt = make_optimizer("adamw", lr=1e-3, total_steps=10, warmup=1)
    got = {}
    for key, model in (("port", m0), ("mesh", m1)):
        params = m0.init(0)
        if key == "mesh":
            S.place_params(m1, params)
        params.requires_grad_(True)
        leaves = reference_leaves(cfg, params)
        before = [[_full(t).clone() for t in leaf.tensors] for leaf in leaves]
        st = TrainState(params, opt.init(leaves), 0)
        state, met = make_train_step(model, opt, microbatches=2)(st.tree(), batch)
        moments, updates = [], []
        for leaf, old in zip(leaves, before):
            mv = [_full(tree_get(state["opt_state"][k], leaf.path)) for k in ("m", "v")]
            moments += mv
            for j, (t, o) in enumerate(zip(leaf.tensors, old)):
                g = (mv[0][j] if leaf.stacked else mv[0]) / (1 - B1)
                updates.append((_full(t), o, g))
        got[key] = (float(met["grad_norm"]), moments, updates)
    (norm, mv, upd), (norm0, mv0, upd0) = got["mesh"], got["port"]
    mv_rel = max(_rel(a, b) for a, b in zip(mv, mv0))
    upd_err, ill, n = 0.0, 0, 0
    for (new, old, _), (new0, _, g0) in zip(upd, upd0):
        u, u0 = new - old, new0 - old
        tol = 1e-4 * u0.abs().max() + torch.finfo(torch.float32).eps * new0.abs()
        ok = (g0 == 0) | ((g0.abs() > 1e-6) & (g0.abs() > 1e-3 * g0.abs().max()))
        ill += int((~ok).sum())
        n += ok.numel()
        upd_err = max(upd_err, float(((u - u0).abs() / tol)[ok].max()))
    return abs(norm - norm0) / norm0, mv_rel, upd_err, norm, ill / n


def rank_checks(_rank, group=None, inputs=None):
    """Every check on this rank; returns FIELDS' values as tensors."""
    import logging
    import tempfile

    import torch as T

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.convert import params_to_reference, reference_leaves
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import TrainState, make_train_step

    # DTensor warns of each multi-dim redistribution it makes
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    out = {}
    mesh = make_test_mesh((2, 2, 2), device="cpu")

    def pair(arch, mesh_=mesh):
        """(cfg, model, weights, mesh model, its weights): the same
        weights, drawn at seed 0, on one device and placed on the mesh."""
        cfg = reduced_config(get_config(arch))
        m0, m1 = build_model(cfg, device="cpu"), build_model(cfg, mesh=mesh_)
        p0, p1 = m0.init(0), m0.init(0)
        S.place_params(m1, p1)
        return cfg, m0, p0, m1, p1

    # --- a train step ------------------------------------------------------
    cfg, m0, p0, m1, p1 = pair("qwen3-32b")
    batch = SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=8, seed=0)).batch(0)
    opt = make_optimizer("adamw", lr=1e-3, total_steps=10, warmup=1)
    leaf0 = {}
    for key, model, params in (("port", m0, p0), ("mesh", m1, p1)):
        params.requires_grad_(True)
        st = TrainState(params, opt.init(reference_leaves(cfg, params)), 0)
        st, met = make_train_step(model, opt)(st.tree(), batch)
        out[f"train_loss_{key}"] = T.tensor(float(met["loss"]))
        first = reference_leaves(cfg, st["params"])[0]
        leaf0[key] = T.stack([t.detach().full_tensor() if key == "mesh" else t.detach()
                              for t in first.tensors]).float()
        out[f"train_leaf_{key}"] = leaf0[key]

    # --- MoE losses, and exact gradients where the functions coincide ------
    for arch, key in (("kimi-k2-1t-a32b", "kimi"), ("grok-1-314b", "grok")):
        cfg, m0, p0, m1, p1 = pair(arch)
        b = SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=8, seed=0)).batch(0)
        with T.no_grad():
            out[f"moe_{key}_port"] = T.tensor(float(m0.loss(p0, b)[0]))
            out[f"moe_{key}_mesh"] = T.tensor(float(m1.loss(p1, b)[0]))
        exact = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
            cfg.moe, router_aux_coef=0.0, capacity_factor=16.0))
        out[f"moe_{key}_grad_rel"] = T.tensor(_grad_rel(exact, mesh, b))

    # --- prefill and one decode step ---------------------------------------
    cfg, m0, p0, m1, p1 = pair("qwen3-32b")
    toks = T.from_numpy(inputs["decode_tokens"])
    step_tok = T.from_numpy(inputs["decode_step_tok"])
    for key, model, params in (("port", m0, p0), ("mesh", m1, p1)):
        _, cache = model.prefill(params, {"tokens": toks}, 32)
        logits, _ = model.decode_step(params, step_tok, cache)
        if key == "mesh":
            logits = logits.full_tensor()
        out[f"decode_{key}"] = logits[:, 0, :cfg.vocab].float()

    # --- checkpoint reshard (2, 2, 2) -> (4, 2) ----------------------------
    cfg = reduced_config(get_config("minitron-8b"))
    m_a = build_model(cfg, mesh=mesh)
    tree = params_to_reference(cfg, m_a.init(0))
    mesh_b = make_test_mesh((4, 2), ("data", "model"), device="cpu")
    m_b = build_model(cfg, mesh=mesh_b)
    with tempfile.TemporaryDirectory() as d:
        d = [d]
        T.distributed.broadcast_object_list(d, src=0)
        ckpt.save(d[0], 7, tree)
        shardings = S.param_shardings(m_b)
        restored, step, _ = ckpt.restore(d[0], like=tree, shardings=shardings)
        T.distributed.barrier()
    equal = placed = True
    for (name, a), (_, b) in zip(ckpt._flatten_with_paths(tree),
                                 ckpt._flatten_with_paths(restored)):
        equal &= bool(T.equal(a.full_tensor(), b.full_tensor()))
        want = ckpt._flatten_with_paths(shardings)
        placed &= b.device_mesh is mesh_b
        placed &= list(b.placements) == dict(want)[name].placements
    out["reshard_equal"] = T.tensor(float(equal))
    out["reshard_placed"] = T.tensor(float(placed))
    out["reshard_step"] = T.tensor(float(step))

    # --- qwen3 on (2, 4): two shards read one kv head -----------------------
    mesh24 = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    cfg, m0, p0, m1, p1 = pair("qwen3-32b", mesh_=mesh24)
    with T.no_grad():
        out["loss_24_port"] = T.tensor(float(m0.loss(p0, batch)[0]))
        out["loss_24_mesh"] = T.tensor(float(m1.loss(p1, batch)[0]))
    out["grad_24_rel"] = T.tensor(_grad_rel(dataclasses.replace(cfg, dtype="float32"),
                                            mesh24, batch))

    # --- qwen2-vl with images and M-RoPE positions -------------------------
    cfg, m0, p0, m1, p1 = pair("qwen2-vl-2b")
    b = SyntheticLM(cfg, DataConfig(seq_len=16, global_batch=8, seed=0)).batch(0)
    with T.no_grad():
        out["vlm_port"] = T.tensor(float(m0.loss(p0, b)[0]))
        out["vlm_mesh"] = T.tensor(float(m1.loss(p1, b)[0]))

    # --- float32 steps: the grad norm and every weight's update --------------
    cfg = reduced_config(get_config("qwen3-32b"))
    for key, mesh_ in (("222", mesh), ("24", mesh24)):
        got = _step_rel(cfg, mesh_, batch)
        for name, x in zip(("norm_rel", "moments_rel", "update_err", "norm", "ill"), got):
            out[f"step_{key}_{name}"] = T.tensor(float(x))
    return tuple(out[f] for f in FIELDS)
