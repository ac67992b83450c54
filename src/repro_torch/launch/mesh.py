"""Device meshes over ``torch.distributed`` ranks, and the paper's
topology-aware rank order (the port's copy of ``repro.launch.mesh``).

Mesh shapes:

    single-pod:  (16, 16)      axes ('data', 'model')          = 256 ranks
    multi-pod:   (2, 16, 16)   axes ('pod', 'data', 'model')   = 512 ranks

A mesh is a ``DeviceMesh`` over the ranks of the default process group,
which the caller initialises (``torch.distributed.init_process_group``
with an explicit address, world size and rank).  Every helper makes a
CUDA mesh unless the caller passes ``device="cpu"`` (a mesh of gloo
ranks); it raises where there is no CUDA device, no process group, or a
group of another size, and never builds a CPU mesh in place of a CUDA one.

``device_order`` applies the paper's lever: a permutation (from
``core.layout.optimize_layout``, or ``optimized_pod_order`` for the pods)
decides which rank lands at which mesh coordinate.  The rank arithmetic
is the pure function ``mesh_ranks``, testable without 512 ranks.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Sequence

import numpy as np
import torch

__all__ = ["PRODUCTION_SHAPES", "mesh_ranks", "local_world", "make_mesh",
           "make_production_mesh", "make_test_mesh", "optimized_pod_order"]

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def mesh_ranks(shape: Sequence[int], device_order: Sequence[int] | None = None) -> np.ndarray:
    """The ranks at each coordinate of a mesh of ``shape``: 0..n-1 in
    row-major order, or ``device_order`` (a permutation of them) in its
    place, as the reference permutes its device list."""
    n = math.prod(shape)
    ranks = np.arange(n)
    if device_order is not None:
        order = [int(i) for i in device_order]
        if sorted(order) != list(range(n)):
            raise ValueError(f"device_order is not a permutation of range({n})")
        ranks = ranks[order]
    return ranks.reshape(tuple(shape))


def _mesh_device(device) -> str:
    """The mesh's device type: CUDA unless the caller asks for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh runs on CUDA devices and none is available; "
                               "pass device='cpu' for a mesh of gloo ranks")
        return "cuda"
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {device!r}: use 'cuda' or 'cpu'")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {device!r} requested but CUDA is not available")
    return kind


@contextlib.contextmanager
def local_world(device=None):
    """A process group of one rank in this process, joined through a
    ``file://`` store in a temporary directory (no network port): NCCL on
    the CUDA device, gloo with ``device="cpu"``.  Yields the device;
    destroys the group on exit.  For a world-size-1 mesh on one card."""
    import torch.distributed as dist

    kind = _mesh_device(device)
    dev = torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else \
        torch.device("cpu")
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0,
                                device_id=dev if kind == "cuda" else None)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None,
              device_order: Sequence[int] | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default process group, which must hold exactly prod(shape) ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    kind = _mesh_device(device)
    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"a ({n}-rank) mesh needs an initialised process group: call "
                           "torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, the process group "
                           f"has {dist.get_world_size()}")
    ranks = torch.from_numpy(mesh_ranks(shape, device_order).copy())
    return DeviceMesh(kind, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_order: Sequence[int] | None = None,
                         device=None):
    """The (16, 16) ('data', 'model') mesh, or (2, 16, 16) ('pod', 'data',
    'model') with ``multi_pod``: raises unless the process group holds
    256 (512) ranks."""
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    return make_mesh(shape, axes, device=device, device_order=device_order)


def make_test_mesh(shape: tuple[int, ...] = (2, 2, 2),
                   axes: tuple[str, ...] = ("pod", "data", "model"), device=None):
    """A small mesh for tests and the single-card smoke: (2, 2, 2) over 8
    gloo ranks with ``device="cpu"``, (1, 1, 1) over one NCCL rank on the
    card."""
    return make_mesh(shape, axes, device=device)


def optimized_pod_order(n_pods: int, degree: int = 4, seed: int = 0,
                        axis_bytes: float = 1.0) -> tuple[list[int], dict]:
    """The paper applied to pods: a minimal-MPL degree-k graph over the
    pods (the configurable inter-pod tier) and the pods ordered along its
    Hamiltonian ring, so the cross-pod collective runs on 1-hop
    neighbours.  Returns (pod order, info: the graph's name, MPL, diameter
    and MPL lower bound), the reference's for the same arguments."""
    from ..core import search

    if n_pods < 4:
        return list(range(n_pods)), {"note": "trivial at <4 pods"}
    res = search.sa_search(n_pods, min(degree, n_pods - 1), seed=seed, n_iter=1500)
    # graphs from sa_search embed the ring 0..n-1: ring order is Hamiltonian
    order = list(range(n_pods))
    info = {
        "pod_graph": res.graph.name,
        "mpl": res.mpl,
        "diameter": res.diameter,
        "mpl_lb": res.mpl_lb,
    }
    return order, info
