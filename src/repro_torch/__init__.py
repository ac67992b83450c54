"""PyTorch/CUDA port of ``repro``, the minimal-MPL topology search.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``core.engines``, ``kernels``) and reproduces its results bit for
bit.  It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro`` — and keeps its own copies of the host helpers it needs.

Every entry point takes an explicit ``device``.  ``None`` means the CUDA
device and raises where there is none; ``"cpu"`` runs the kernels' plain
PyTorch versions and is honoured only when the caller asks for it.

Ported so far: the device-priced replica polish,
``repro_torch.core.search.large_search(n, k, replicas=R)``, whose two
kernels (the word-packed BFS sweep and the min-plus insert patch) are
hand-written CUDA C++ in ``kernels/csrc/bfs_sweep.cu``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
