"""PyTorch/CUDA port of ``repro``: the minimal-MPL topology search and the
model-zoo harness around it.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``api``, ``core``, ``core.engines``, ``comm``, ``kernels``, ``configs``,
``models``, ``serve``, ``launch``, ``runtime``).  Search results equal the reference's bit for bit;
model outputs match within the reference's own test tolerances.  It
imports ``torch`` and ``numpy`` only — never ``jax`` and nothing of
``repro`` — and keeps its own copies of the host helpers it needs.

Every entry point takes an explicit ``device``.  ``None`` means the CUDA
device and raises where there is none; ``"cpu"`` runs the kernels' plain
PyTorch versions and is honoured only when the caller asks for it.

Ported so far:

- the paper's small-N tiers and its evidence chain:
  ``core.search.sa_search`` (Algorithm 1: replica annealing over 2-edge
  swaps, priced by ``core.metrics.IncrementalAPSP``),
  ``exhaustive_search`` and ``sa_objective_search``, on the host as in the
  reference; the named topologies of Tables 1 and 2 (``core.graphs``); the
  graph invariants of ``core.metrics`` (``apsp``/``apsp_hops`` on the
  device through the BFS sweep kernel, ``stats``, ``girth``,
  ``bisection_width``); the certified best-known-graph table and its
  independent host recomputation (``core.certify``, ``data/certified.json``,
  which ``core.known_optimal`` loads);
- the large-N search tier, ``repro_torch.core.search.large_search(n, k)``:
  the circulant warm start (its batched pricer in
  ``core.engines.torch_circulant``), then the single-chain
  ``symmetric_sa_search`` (``replicas=1``, the default; priced by
  ``core.metrics.SymmetricAPSP``) or the device-priced replica polish
  (``replicas=R >= 2``).  Both polishes price through two kernels (the
  word-packed BFS sweep and the min-plus insert patch), hand-written CUDA
  C++ in ``kernels/csrc/bfs_sweep.cu``;
- the serving path of the hybrid (zamba2-2.7b), dense (qwen3-32b and the
  other dense configs) and SSM (mamba2-2.7b) families:
  ``configs``, ``models`` (``build_model``, ``Model.init/prefill/
  decode_step``), ``serve.ServingEngine`` and ``launch.serve``, whose two
  kernels are hand-written CUDA C++: forward attention
  (``kernels/csrc/flash_attention.cu``) and the Mamba2 SSD intra-chunk term
  (``kernels/csrc/ssd_scan.cu``).  ``convert.params_from_reference`` loads
  the JAX package's weights.

- the paper's simulated-cluster evidence (Tables 4-6, Figs 2-10) through
  one facade, ``repro_torch.api`` (``run_experiment``, ``build_topology``,
  ``search``, ``paper_suite``, the ``python -m repro_torch.api`` CLI): the
  declarative specs and registries (``core.specs``, ``core.topologies``),
  and on the host as in the reference the routing tiers
  (``core.routing``), the collective schedules (``core.collectives``,
  ``comm.schedules``), the traffic patterns and the benchmark models
  (``core.traffic``, ``core.netsim``).  Searched graphs and ``stats`` price
  on the device through the same BFS kernels;
- the paper's step 4: the topology-aware layout (``core.layout``, the
  annealer on the host over ``apsp`` on the device), the elastic remesh
  after failures (``runtime``) and the Hamiltonian-ring collectives over
  ``torch.distributed`` (``comm.torchcoll``); the paper's table and figure
  scripts are ``benchmarks/torch_*.py`` (``benchmarks/torch_run.py``).

The other model families, loss and training are not ported yet
(ROADMAP.md).
"""
from .core.certify import certify, verify_entry
from .core.metrics import IncrementalAPSP, apsp, apsp_hops, bisection_width, girth, stats
from .core.search import exhaustive_search, large_search, sa_objective_search, sa_search
from .device import resolve_device

__all__ = [
    "IncrementalAPSP",
    "apsp",
    "apsp_hops",
    "bisection_width",
    "certify",
    "exhaustive_search",
    "girth",
    "large_search",
    "resolve_device",
    "sa_objective_search",
    "sa_search",
    "stats",
    "verify_entry",
]
