"""PyTorch/CUDA port of ``repro``: the minimal-MPL topology search and the
model-zoo harness around it.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``core.engines``, ``kernels``, ``configs``, ``models``,
``serve``, ``launch``).  Search results equal the reference's bit for bit;
model outputs match within the reference's own test tolerances.  It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro`` — and keeps its own copies of the host helpers it needs.

Every entry point takes an explicit ``device``.  ``None`` means the CUDA
device and raises where there is none; ``"cpu"`` runs the kernels' plain
PyTorch versions and is honoured only when the caller asks for it.

Ported so far:

- the large-N search tier, ``repro_torch.core.search.large_search(n, k)``:
  the circulant warm start (its batched pricer in
  ``core.engines.torch_circulant``), then the single-chain
  ``symmetric_sa_search`` (``replicas=1``, the default; priced by
  ``core.metrics.SymmetricAPSP``) or the device-priced replica polish
  (``replicas=R >= 2``).  Both polishes price through two kernels (the
  word-packed BFS sweep and the min-plus insert patch), hand-written CUDA
  C++ in ``kernels/csrc/bfs_sweep.cu``;
- the serving path of the hybrid family (zamba2-2.7b):
  ``configs``, ``models`` (``build_model``, ``Model.init/prefill/
  decode_step``), ``serve.ServingEngine`` and ``launch.serve``, whose two
  kernels are hand-written CUDA C++: forward attention
  (``kernels/csrc/flash_attention.cu``) and the Mamba2 SSD intra-chunk term
  (``kernels/csrc/ssd_scan.cu``).  ``convert.params_from_reference`` loads
  the JAX package's weights.

Other model families, loss and training are not ported yet (ROADMAP.md).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
