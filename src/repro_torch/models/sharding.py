"""Logical-axis sharding rules, the glue between model code and a device
mesh (the port's copy of ``repro.models.sharding``, on
``torch.distributed``'s ``DeviceMesh`` and DTensor).

Model code names a tensor's dims with *logical* names
(``rules.shard(x, "batch", "seq", "embed")``); a ``ShardingRules`` maps
each name to zero or more *mesh* axes and drops any constraint that does
not divide the dim (whisper-tiny's 6 heads on a 16-way model axis).  The
same model code runs without a mesh (rules with ``mesh=None`` are a
no-op: tensors stay plain), on a CPU mesh of gloo ranks and on a CUDA
mesh over NCCL.

``spec`` gives the reference's PartitionSpec entries (``None``, an axis
name, or a tuple of names); ``placements`` gives the same layout as
DTensor placements, one per mesh dim: ``Shard(i)`` where tensor dim i is
split over that mesh dim, else ``Replicate()``.  A tuple entry such as
``("pod", "data")`` splits dim i over both mesh dims in mesh order, as
the reference's does.  The rules read only the mesh's ``mesh_dim_names``
and ``shape``, so a stand-in with those two attributes serves to compute
specs for a mesh that does not exist (the production mesh's 512 ranks).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["ShardingRules", "DEFAULT_RULES", "NamedSharding", "make_rules", "Shards", "NO_MESH",
           "AllToAll", "all_max", "all_min", "fanout", "gather", "group_size", "pmean", "psum",
           "split"]

# logical name -> preferred mesh axes (filtered against the actual mesh);
# equal to the reference's table
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    # activations
    "batch": ("pod", "data"),
    "seq": (),
    # sequence parallelism: off by default, enabled per arch by overrides
    "seq_sp": (),
    "embed": (),
    "heads": ("model",),
    "kv_heads": (),
    "head_dim": (),
    "ff": ("model",),
    "vocab": ("model",),
    "kv_seq": ("model",),  # decode: KV cache sequence dim
    "expert": ("model",),  # ep-mode MoE
    "ssm_heads": ("model",),
    "state": (),
    # weights
    "w_embed": ("data",),  # FSDP dim of every weight
    "w_vocab": ("model",),
    "w_heads": ("model",),
    "w_kv_heads": (),
    "w_ff": ("model",),
    "w_expert": ("model",),
    # expert weights' inner dims: FSDP on d_model by default; decode cells
    # may flip to fe-sharding ('w_exp_fe' -> data), weight-stationary
    "w_exp_in": ("data",),
    "w_exp_fe": (),
    "w_ssm_heads": ("model",),
    "w_conv": (),
    "w_none": (),
}


def _placements(mesh, spec: tuple) -> list:
    """DTensor placements, one per mesh dim, of a PartitionSpec's entries."""
    from torch.distributed.tensor import Replicate, Shard

    out: list = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            i = mesh.mesh_dim_names.index(axis)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {axis!r} shards two dims of spec {spec}")
            out[i] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a PartitionSpec (the reference's ``NamedSharding``); its
    ``placements`` are the DTensor layout.  ``layer()`` is the sharding of
    one layer of a stacked leaf: the spec without its leading (layer)
    entry, which the rules never shard."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> list:
        return _placements(self.mesh, self.spec)

    def layer(self) -> "NamedSharding":
        if self.spec and self.spec[0] is not None:
            raise ValueError(f"the layer axis of spec {self.spec} is sharded")
        return NamedSharding(self.mesh, self.spec[1:])


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any  # a DeviceMesh (or a stand-in with mesh_dim_names and shape), or None
    rules: dict[str, tuple[str, ...]]

    # ------------------------------------------------------------------
    def axes_for(self, name: str | None) -> tuple[str, ...]:
        if name is None or self.mesh is None:
            return ()
        axes = self.rules.get(name, ())
        return tuple(a for a in axes if a in self.mesh.mesh_dim_names)

    def _axis_size(self, axes: tuple[str, ...]) -> int:
        names = tuple(self.mesh.mesh_dim_names)
        return math.prod(self.mesh.shape[names.index(a)] for a in axes)

    def spec(self, *names: str | None, dims: tuple[int, ...] | None = None) -> tuple:
        """PartitionSpec entries for logical dim names; constraints that do
        not divide the corresponding dim (when ``dims`` is given) are
        dropped."""
        entries: list[Any] = []
        for i, nm in enumerate(names):
            axes = self.axes_for(nm)
            if dims is not None and axes and dims[i] % self._axis_size(axes) != 0:
                axes = ()
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(tuple(axes))
        return tuple(entries)

    def placements(self, *names: str | None, dims: tuple[int, ...] | None = None) -> list:
        """DTensor placements, one per mesh dim, for logical dim names."""
        if self.mesh is None:
            raise ValueError("rules without a mesh have no placements")
        return _placements(self.mesh, self.spec(*names, dims=dims))

    def sharding(self, *names: str | None, dims: tuple[int, ...] | None = None):
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(*names, dims=dims))

    def shard(self, x: torch.Tensor, *names: str | None) -> torch.Tensor:
        """Redistribute a DTensor to the layout the names give; no-op
        without a mesh.  A plain tensor on a mesh is taken as the same full
        tensor on every rank and split without communication."""
        if self.mesh is None:
            return x
        if len(names) != x.dim():
            raise ValueError(f"{len(names)} names for rank-{x.dim()} tensor")
        from torch.distributed.tensor import DTensor, distribute_tensor

        pl = self.placements(*names, dims=tuple(x.shape))
        if isinstance(x, DTensor):
            if list(x.placements) == pl:
                return x
            return x.redistribute(self.mesh, pl)
        return distribute_tensor(x, self.mesh, pl, src_data_rank=None)

    # ------------------------------------------------------------------
    def data_shards(self) -> int:
        return self._axis_size(self.axes_for("batch")) if self.mesh is not None else 1

    def model_shards(self) -> int:
        return self._axis_size(self.axes_for("heads")) if self.mesh is not None else 1


def make_rules(mesh, overrides: dict[str, tuple[str, ...]] | None = None) -> ShardingRules:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return ShardingRules(mesh=mesh, rules=rules)


# logical names that may map to the model axis, and those that must not map
# to any axis, for the model code that runs on a mesh
_MODEL_NAMES = ("heads", "ff", "vocab", "kv_seq", "expert", "w_heads", "w_ff", "w_vocab",
                "w_expert")
_WHOLE_NAMES = ("seq", "seq_sp", "embed", "kv_heads", "head_dim", "w_kv_heads")


class Shards:
    """One rank's view of a mesh under the rules: the model axis's group
    (the tensor-parallel splits), the batch axes' groups, and this rank's
    place on them.  Without a mesh every group is None, every size 1 and
    every rank 0, so the collectives above return their inputs
    (``NO_MESH``).  Raises ``NotImplementedError`` for rules the model code
    does not run (sequence parallelism, a split embed or kv-head dim,
    tensor parallelism over more than one axis)."""

    def __init__(self, rules: ShardingRules):
        mesh = rules.mesh
        self.mesh, self.rules = mesh, rules
        self.names = () if mesh is None else tuple(mesh.mesh_dim_names)
        model = rules.axes_for("heads")
        if len(model) > 1:
            raise NotImplementedError(f"heads over {model}: one model axis at most")
        self.model_axis = model[0] if model else None
        for name in _MODEL_NAMES:
            if rules.axes_for(name) not in ((), tuple(model)):
                raise NotImplementedError(f"{name!r} -> {rules.axes_for(name)} on a mesh "
                                          f"(the model axis is {self.model_axis!r})")
        for name in _WHOLE_NAMES:
            if rules.axes_for(name):
                raise NotImplementedError(f"{name!r} -> {rules.axes_for(name)} on a mesh")
        self.batch_axes = rules.axes_for("batch")
        if self.model_axis in self.batch_axes:
            raise NotImplementedError("the batch and the heads share the model axis")

    def dim(self, axis: str) -> int:
        return self.names.index(axis)

    def group(self, axis: str | None):
        return None if axis is None else self.mesh.get_group(self.dim(axis))

    def size(self, axis: str | None) -> int:
        return 1 if axis is None else self.mesh.size(self.dim(axis))

    def rank(self, axis: str | None) -> int:
        return 0 if axis is None else self.mesh.get_local_rank(self.dim(axis))

    @property
    def model(self):
        return self.group(self.model_axis)

    @property
    def model_size(self) -> int:
        return self.size(self.model_axis)

    @property
    def model_rank(self) -> int:
        return self.rank(self.model_axis)

    @property
    def batch_groups(self) -> tuple:
        return tuple(self.group(a) for a in self.batch_axes)

    @property
    def batch_size(self) -> int:
        return math.prod(self.size(a) for a in self.batch_axes)

    @property
    def batch_rank(self) -> int:
        r = 0
        for a in self.batch_axes:
            r = r * self.size(a) + self.rank(a)
        return r

    def local_batch(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of a full batch tensor (all of them where the
        batch does not split evenly, as the rules drop the constraint)."""
        n = self.batch_size
        if n == 1 or x.shape[dim] % n:
            return x
        return x.chunk(n, dim=dim)[self.batch_rank]


NO_MESH = Shards(make_rules(None))


# ------------------------------------------------------------------------------
# Collectives over one mesh dim's process group, with their gradients (the
# counterparts of shard_map's all_gather, all_to_all, psum and pmean).  A
# group of one rank is no collective at all: each helper returns its input
# as it is, so a (1, 1, 1) mesh runs the single-device arithmetic.
# ------------------------------------------------------------------------------

def group_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    return x.chunk(group_size(group), dim=dim)[dist.get_rank(group)].contiguous()


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous().clone()
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``.  Backward: with ``partial`` the gradients
    are each rank's partial sums (an FSDP weight used on each rank's own
    tokens): summed, then this rank's slice (a reduce-scatter); without,
    they are the same on every rank and this rank's slice is kept."""

    @staticmethod
    def forward(ctx, x, dim, group, partial):
        ctx.dim, ctx.group, ctx.partial = dim, group, partial
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = _all_reduce(g, ctx.group)
        return _chunk(g, ctx.dim, ctx.group), None, None, None


class _Split(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor replicated over the
    group; backward: the slices' gradients gathered (``_Gather``'s
    mirror)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class AllToAll(torch.autograd.Function):
    """Equal-split all-to-all along dim 0; its own inverse, so also its
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return AllToAll.forward(ctx, g, ctx.group), None


class _Psum(torch.autograd.Function):
    """Sum of partial results over the group; the sum is replicated, so
    each partial's gradient is the sum's (identity backward)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Fanout(torch.autograd.Function):
    """Identity into work split over the group; backward sums the split
    work's gradients (``_Psum``'s mirror: Megatron's f and g)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Pmean(torch.autograd.Function):
    """Mean over the groups' ranks of each rank's value (over its own
    tokens); backward: the mean's gradient over the count."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.n = n
        for group in groups:
            x = _all_reduce(x, group)
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def gather(x: torch.Tensor, dim: int, group, partial: bool = True) -> torch.Tensor:
    return x if group_size(group) == 1 else _Gather.apply(x, dim, group, partial)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Split.apply(x, dim, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Psum.apply(x, group)


def fanout(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _Fanout.apply(x, group)


def pmean(x: torch.Tensor, groups: tuple) -> torch.Tensor:
    n = math.prod(group_size(g) for g in groups)
    return x if n == 1 else _Pmean.apply(x, tuple(groups), n)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group (no gradient)."""
    import torch.distributed as dist

    return x if group_size(group) == 1 else _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def all_min(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    return x if group_size(group) == 1 else _all_reduce(x.detach(), group, dist.ReduceOp.MIN)
