"""Training loop: the microbatched train step and the fault-tolerant
``Trainer`` (the port's copy of ``repro.train.trainer``).

``make_train_step`` builds the step:
  * gradient accumulation over ``cfg.microbatches``: each microbatch's
    gradients (``torch.autograd.grad`` of ``Model.loss``) are added into an
    fp32 buffer, then divided, as the reference's fp32 scan carry; with one
    microbatch the optimizer gets the gradients in the parameters' dtype;
  * global-norm clipping and the optimizer update, in place (the reference
    donates its old state to the jitted step instead).

``Trainer`` adds the production concerns:
  * checkpoint every N steps in the reference's layout (the param tree
    restacked by ``convert.params_to_reference``, the optimizer state,
    the step and the data iterator's state), so either package restores
    the other's checkpoints;
  * crash-restart: ``Trainer.restore()`` resumes the step count, weights,
    optimizer state and the data stream (deterministic skip-ahead);
  * straggler watch: steps slower than ``straggler_factor`` x the median of
    the last 50 are logged and counted;
  * a failure injection hook for tests.

The state is ``{"params": nn.Module, "opt_state": reference-shaped nested
dict, "step": int}``: the step counter is a Python int (the reference's is
an int32 device scalar; a checkpoint writes it as one).

On a mesh (a model from ``build_model(cfg, mesh=...)``) the parameters
and AdamW's state are DTensors placed by ``launch.specs``; each rank runs
the step on the same full batch, of which ``Model.loss`` keeps this
rank's rows.  A weight's gradient may be a partial sum (over the batch
axes, where each rank's tokens differ): the microbatches' gradients are
summed in fp32 on the local shards, and the optimizer reduces each
partial sum once a step (``optimizers.as_param_placements``).  A
checkpoint holds full tensors (gathered, written by rank 0), and
``restore`` places them onto this trainer's mesh, whatever mesh wrote
them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.profiler import record_function

from ..checkpoint import ckpt
from ..convert import params_to_reference, reference_leaves
from ..data.pipeline import SyntheticLM
from ..models.zoo import Model
from ..optim import Optimizer
from ..optim.optimizers import tree_get

__all__ = ["SPAN_GRADS", "SPAN_OPTIMIZER", "TrainState", "init_state", "make_train_step",
           "Trainer"]

# torch.profiler ranges of a step (they cost nothing while no profiler
# records): a microbatch's loss and gradients, and the optimizer's update
SPAN_GRADS = "train_step: loss and gradients"
SPAN_OPTIMIZER = "train_step: optimizer update"


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int

    def tree(self) -> dict:
        return {"params": self.params, "opt_state": self.opt_state, "step": self.step}


def init_state(model: Model, opt: Optimizer, seed: int = 0) -> TrainState:
    """Fresh weights (``model.init(seed)``, with gradients on) and optimizer
    state, at step 0."""
    params = model.init(seed).requires_grad_(True)
    return TrainState(params=params, opt_state=opt.init(reference_leaves(model.cfg, params)),
                      step=0)


def _split(batch: dict, microbatches: int) -> list[dict]:
    """The batch's microbatches along the batch axis (axis 1 of M-RoPE's
    (3, b, s) positions)."""
    def part(name, x, i):
        if name == "positions" and x.dim() == 3 and x.shape[0] == 3:
            n = x.shape[1] // microbatches
            return x[:, i * n:(i + 1) * n]
        n = x.shape[0] // microbatches
        return x[i * n:(i + 1) * n]

    return [{k: part(k, torch.as_tensor(v), i) for k, v in batch.items()}
            for i in range(microbatches)]


def make_train_step(model: Model, opt: Optimizer, microbatches: int = 1) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), updating the
    state in place.  The metrics are the last microbatch's (detached
    tensors), with ``loss`` the mean over the microbatches, and the
    optimizer's ``grad_norm`` and ``lr``."""

    def grads_of(params, leaves, batch):
        with record_function(SPAN_GRADS):
            loss, metrics = model.loss(params, batch)
            flat = [t for leaf in leaves for t in leaf.tensors]
            gs = torch.autograd.grad(loss, flat, allow_unused=True)
            gs = [_zeros_like(t) if g is None else g for t, g in zip(flat, gs)]
        return loss.detach(), metrics, gs

    def regroup(leaves, flat):
        out, i = [], 0
        for leaf in leaves:
            out.append(flat[i:i + len(leaf.tensors)])
            i += len(leaf.tensors)
        return out

    def train_step(state: dict, batch: dict):
        params = state["params"]
        leaves = reference_leaves(model.cfg, params)
        if microbatches == 1:
            loss, metrics, flat = grads_of(params, leaves, batch)
        else:
            # fp32 sums of the local shards: a partial sum over the batch axes
            # stays one until the optimizer reduces it, once a step
            accs = [_zeros_f32(t) for leaf in leaves for t in leaf.tensors]
            loss = 0.0
            for mb in _split(batch, microbatches):
                l, metrics, gs = grads_of(params, leaves, mb)
                for acc, g in zip(accs, gs):
                    acc.add_(_local(g))
                layouts = [_layout(g) for g in gs]
                del gs
                loss = loss + l
            for acc in accs:
                acc.div_(microbatches)
            flat = [_placed(acc, lay) for acc, lay in zip(accs, layouts)]
            loss = loss / microbatches
        metrics = dict(metrics, loss=loss)
        with record_function(SPAN_OPTIMIZER):
            stats = opt.update(regroup(leaves, flat), state["opt_state"], leaves, state["step"])
        state["step"] += 1
        return state, dict(metrics, **stats)

    return train_step


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or the tensor."""
    return t.to_local() if hasattr(t, "to_local") else t


def _zeros_f32(t: torch.Tensor) -> torch.Tensor:
    """An fp32 accumulator for the gradient of ``t``'s local shard."""
    local = _local(t)
    return torch.zeros(local.shape, dtype=torch.float32, device=local.device)


def _layout(g: torch.Tensor):
    """A DTensor gradient's (mesh, placements), a partial sum's included;
    None for a plain tensor."""
    return (g.device_mesh, g.placements) if hasattr(g, "to_local") else None


def _placed(acc: torch.Tensor, layout) -> torch.Tensor:
    """An accumulated local gradient as the DTensor ``layout`` says."""
    if layout is None:
        return acc
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(acc, *layout, run_check=False)


def _zeros_like(t: torch.Tensor) -> torch.Tensor:
    """A zero gradient for ``t`` (a DTensor placed as ``t`` on a mesh)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        local = t.to_local()
        return DTensor.from_local(torch.zeros_like(local), t.device_mesh, t.placements,
                                  run_check=False)
    return torch.zeros_like(t)


@dataclasses.dataclass
class Trainer:
    model: Model
    opt: Optimizer
    data: SyntheticLM
    ckpt_dir: str | None = None
    ckpt_every: int = 100
    straggler_factor: float = 3.0
    state: dict | None = None

    # runtime stats
    step_times: list = dataclasses.field(default_factory=list)
    stragglers: int = 0
    failure_hook: Callable[[int], None] | None = None

    def __post_init__(self):
        self._step_fn = make_train_step(self.model, self.opt,
                                        microbatches=self.model.cfg.microbatches)

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> None:
        self.state = init_state(self.model, self.opt, seed).tree()

    def reference_tree(self) -> dict:
        """The state as the reference's tree: what a checkpoint holds."""
        return {"params": params_to_reference(self.model.cfg, self.state["params"]),
                "opt_state": self.state["opt_state"],
                "step": np.asarray(self.state["step"], np.int32)}

    def restore(self) -> bool:
        """Resume from the latest checkpoint. Returns True if restored."""
        if not self.ckpt_dir:
            return False
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return False
        if self.state is None:
            self.init()
        shardings = None
        if self.model.mesh is not None:
            from ..launch import specs

            shardings = dict(specs.train_state_specs(self.model, self.opt, self.opt.name)[1],
                             step=None)
        tree, _, extras = ckpt.restore(self.ckpt_dir, step, like=self.reference_tree(),
                                       shardings=shardings)
        cfg = self.model.cfg
        with torch.no_grad():
            for leaf in reference_leaves(cfg, self.state["params"]):
                saved = tree_get(tree["params"], leaf.path)
                for j, t in enumerate(leaf.tensors):
                    t.copy_(saved[j] if leaf.stacked else saved)
            _copy_into(self.state["opt_state"], tree["opt_state"])
        self.state["step"] = int(tree["step"])
        self.data.restore(extras.get("data", {"step": step}))
        return True

    def save(self) -> None:
        if not self.ckpt_dir or self.state is None:
            return
        ckpt.save(self.ckpt_dir, int(self.state["step"]), self.reference_tree(),
                  extras={"data": self.data.state()})

    # ------------------------------------------------------------------
    def train(self, n_steps: int, log_every: int = 10, log_fn=print) -> list[dict]:
        if self.state is None:
            raise RuntimeError("call init() or restore() first")
        history = []
        dev = self.model.device
        for _ in range(n_steps):
            step_no = int(self.state["step"])
            if self.failure_hook is not None:
                self.failure_hook(step_no)  # may raise to simulate a crash
            t0 = time.perf_counter()
            batch = self.data.batch()
            self.state, metrics = self._step_fn(self.state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if len(self.step_times) >= 5:
                med = float(np.median(self.step_times[-50:]))
                if dt > self.straggler_factor * med:
                    self.stragglers += 1
                    log_fn(f"[straggler] step {step_no}: {dt:.3f}s vs median {med:.3f}s")
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step_no
            m["time_s"] = dt
            history.append(m)
            if log_every and step_no % log_every == 0:
                log_fn(f"step {step_no:5d} loss {m.get('loss', float('nan')):.4f} "
                       f"({dt*1e3:.0f} ms)")
            if self.ckpt_dir and (step_no + 1) % self.ckpt_every == 0:
                self.save()
        return history


def _copy_into(dst: dict, src: dict) -> None:
    """Copy a restored nested dict's tensors into the live one, in place."""
    for key, value in dst.items():
        if isinstance(value, dict):
            _copy_into(value, src[key])
        else:
            value.copy_(src[key])
