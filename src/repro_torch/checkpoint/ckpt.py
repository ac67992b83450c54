"""Checkpoints with atomic manifests: the port's copy of
``repro.checkpoint.ckpt``, in the reference's layout, so that a
checkpoint written by either package restores into the other.

Layout:
    <dir>/step_000123/
        MANIFEST.json        # leaf names, shapes, dtypes, step, extras
        <leaf-path>.bin      # raw little-endian bytes per leaf
    <dir>/LATEST             # atomic pointer (written last, via os.rename)

A tree is nested dicts whose leaves are tensors, numpy arrays or numbers;
a leaf is named by its path, the keys joined with "/" (``params/blocks/
attn/wq``, ``opt_state/m/...``, ``step``), and leaves are written in the
reference's flatten order (keys sorted at every level).  The manifest is
written after all leaves and LATEST after the manifest, so a crash
mid-save never corrupts the restore path.  bfloat16 is written as its raw
bytes with the dtype string ``"bfloat16"`` (as the reference's
``str(arr.dtype)``) and read back through its 16-bit pattern, without
``ml_dtypes``.

On a mesh a tree's leaves may be DTensors: every rank calls ``save``,
each DTensor is gathered whole (a collective, in the same leaf order on
every rank), rank 0 writes, and a barrier ends the call, so the files
are the same as one device's.  ``restore(..., shardings=...)`` (the
reference's reshard-on-restore, the elastic-rescale path) places each
leaf onto its sharding's mesh and placements, whatever mesh wrote it;
without shardings restored leaves are CPU tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "list_steps"]

_SEP = "/"
_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8",
                torch.bool: "bool"}


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(name, leaf) pairs of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten_with_paths(tree[key], f"{prefix}{_SEP}{key}" if prefix else str(key))
        return out
    return [(prefix, tree)]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _bytes(leaf) -> tuple:
    """A leaf's raw bytes (a buffer: a tensor's host copy, not copied
    again), shape and dtype string (a DTensor's gathered whole: every rank
    must call this for it)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _TORCH_NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return memoryview(t.numpy().reshape(-1)).cast("B"), list(leaf.shape), name
    arr = np.asarray(leaf)
    return arr.tobytes(), list(arr.shape), str(arr.dtype)


def _leaf(path: str, meta: dict) -> torch.Tensor:
    """A leaf's file read back as a CPU tensor of its dtype and shape."""
    shape = meta["shape"]
    if meta["dtype"] == "bfloat16":
        bits = np.fromfile(path, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.fromfile(path, dtype=np.dtype(meta["dtype"])).reshape(shape))


def save(ckpt_dir: str, step: int, tree: Any, extras: dict | None = None) -> str:
    """Atomically save a tree for ``step``. Returns the step directory.
    With DTensor leaves every rank calls it; rank 0 writes."""
    leaves = _flatten_with_paths(tree)
    if not any(_is_dtensor(leaf) for _, leaf in leaves):
        return _write(ckpt_dir, step, [(name, _bytes(leaf)) for name, leaf in leaves], extras)
    import torch.distributed as dist

    data = [(name, _bytes(leaf)) for name, leaf in leaves]  # collective per DTensor
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    try:
        if dist.get_rank() == 0:
            final = _write(ckpt_dir, step, data, extras)
    finally:
        dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, data: list, extras: dict | None) -> str:
    """Write (name, (bytes, shape, dtype)) leaves as step ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    manifest = {"step": step, "extras": extras or {}, "leaves": {}}
    try:
        for name, (buf, shape, dtype) in data:
            fn = name.replace(_SEP, "__") + ".bin"
            with open(os.path.join(tmp, fn), "wb") as f:
                f.write(buf)
            manifest["leaves"][name] = {"file": fn, "shape": shape, "dtype": dtype}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic LATEST pointer
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.rename(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in sorted(os.listdir(ckpt_dir)):
        if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, "MANIFEST.json")):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        if os.path.exists(os.path.join(ckpt_dir, name, "MANIFEST.json")):
            return int(name.split("_")[1])
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _place(t: torch.Tensor, sharding) -> torch.Tensor:
    """A full CPU tensor as a DTensor on ``sharding``'s mesh and placements
    (each rank keeps its shard; no communication)."""
    if sharding is None:
        return t
    from torch.distributed.tensor import distribute_tensor

    mesh = sharding.mesh
    dev = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
           else torch.device(mesh.device_type))
    return distribute_tensor(t.to(dev), mesh, sharding.placements, src_data_rank=None)


def restore(ckpt_dir: str, step: int | None = None, like: Any | None = None,
            shardings: Any | None = None) -> tuple[Any, int, dict]:
    """Restore (tree, step, extras), leaves as CPU tensors.

    ``like``: a nested dict of the target structure (its leaves' names are
    read); without it the tree is flat, ``{name: tensor}``.
    ``shardings``: a nested dict matching ``like`` of ``NamedSharding``s
    (``launch.specs``) or None leaves: each leaf is placed onto its mesh
    (reshard-on-restore, elastic rescale); a None leaf stays on the CPU.
    """
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)

    def load_leaf(name: str) -> torch.Tensor:
        meta = manifest["leaves"][name]
        return _leaf(os.path.join(d, meta["file"]), meta)

    if like is None:
        return ({name: load_leaf(name) for name in manifest["leaves"]}, manifest["step"],
                manifest["extras"])
    names = [n for n, _ in _flatten_with_paths(like)]
    missing = [n for n in names if n not in manifest["leaves"]]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]} (+{max(len(missing) - 5, 0)})")
    tree: dict = {}
    for name in names:
        node, sh = tree, shardings
        *keys, last = name.split(_SEP)
        for key in keys:
            node = node.setdefault(key, {})
            sh = sh[key] if sh is not None else None
        node[last] = _place(load_leaf(name), sh[last] if sh is not None else None)
    return tree, manifest["step"], manifest["extras"]
