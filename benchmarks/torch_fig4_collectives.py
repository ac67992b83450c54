"""Paper Fig 4 with the port: MPI_Bcast / Reduce / Scatter / Alltoall ratios
to ring at 1 MB and 32 MB unit messages, the legacy rank-space heuristics
(``<op>-<size>``) beside the per-topology synthesized schedules
(``<op>-<size>-synth``) — the counterpart of
``benchmarks/fig4_collectives.py``.  ``save()`` writes
``results/torch_benchmarks/BENCH_fig4.json``, every row with its topology's
replayable ``TopologySpec`` JSON and the exact workload params."""
from repro_torch import api

from . import torch_common as common

OPS = ("bcast", "reduce", "scatter", "alltoall")
SYNTH_OPS = ("bcast", "reduce", "scatter", "allreduce")
SIZES = {"1MB": 1 << 20, "32MB": 32 << 20}


def run(device=None) -> common.Rows:
    rows = common.Rows("fig4", artifact="fig4")
    workloads = [(f"{op}-{sz_name}", "collective", {"op": op, "unit_bytes": sz})
                 for op in OPS for sz_name, sz in SIZES.items()]
    workloads += [(f"{op}-{sz_name}-synth", "collective_synth",
                   {"op": op, "unit_bytes": sz})
                  for op in SYNTH_OPS for sz_name, sz in SIZES.items()]
    for key in ("16", "32"):
        exp = api.run_experiment(api.paper_suite(key), workloads=workloads,
                                 cache_dir=common.CACHE_DIR, device=device)
        prov = exp.provenance()
        for wkey, wname, params in workloads:
            ratios = exp.ratios(wkey)
            for name in exp.names:
                rows.add(f"{wkey}/{name}", exp.values[name][wkey],
                         f"ratio={ratios[name]:.3f}")
                rows.results.append({
                    "suite": key, "key": wkey, "workload": wname,
                    "params": params, "topology": name,
                    "seconds": exp.values[name][wkey],
                    "ratio_vs_ring": round(ratios[name], 4),
                    "spec": prov[name],
                })
    return rows
