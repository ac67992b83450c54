"""Routing-tier benchmark with the port: static vs congestion-aware adaptive
routing (the counterpart of ``benchmarks/fig_routing.py``).

The same topologies are priced under ``routing="static"`` (the paper's
model) and ``routing="adaptive"`` (``repro_torch.core.routing``) across the
synthetic sweeps (uniform / transpose / shift / hotspot) and the torus
alltoall collective.  ``save()`` writes
``results/torch_benchmarks/BENCH_routing.json``; its ``torus_alltoall``
row's ``adaptive_vs_static`` must exceed 1 (adaptive relieves the torus
congestion collapse).  The topologies are constructive and the models run
on the host: ``device`` only goes to ``build_topology``.
"""
import dataclasses
import json
import time

from repro_torch import api
from repro_torch.core import netsim

from . import torch_common as common

#: (display key, spec) — constructive families only
TOPOLOGIES = (
    ("ring32", "ring:32"),
    ("torus4x8", "torus:4x8"),
    ("chvatal32", "chvatal32"),
    ("clusterhub4x8", "cluster-hub:4x8"),
)

PATTERNS = ("uniform", "transpose", "shift", "hotspot")
NBYTES = 1 << 20
SEED = 0


def _clusters(graph):
    cl = netsim.TAISHAN(graph)
    return cl, dataclasses.replace(cl, routing="adaptive")


def run(device=None) -> common.Rows:
    rows = common.Rows("fig_routing", artifact="routing")
    results = rows.results
    for key, spec_str in TOPOLOGIES:
        spec = api.parse_topology(spec_str)
        g = api.build_topology(spec, device=device)
        cl_s, cl_a = _clusters(g)
        for pattern in PATTERNS:
            t0 = time.perf_counter()
            s = netsim.traffic_time(cl_s, pattern, NBYTES, seed=SEED)
            a = netsim.traffic_time(cl_a, pattern, NBYTES, seed=SEED)
            wall = time.perf_counter() - t0
            ratio = s / a
            rows.add(f"{pattern}/{key}", wall,
                     f"static={s:.3g}s adaptive={a:.3g}s ratio={ratio:.3f}")
            results.append({
                "key": f"{pattern}_{key}", "topology": g.name,
                "pattern": pattern, "nbytes": NBYTES, "seed": SEED,
                "static_s": s, "adaptive_s": a,
                "adaptive_vs_static": round(ratio, 4),
                "spec": json.loads(spec.to_json()),
            })

    # the congestion-collapse row: the paper's 32-node torus alltoall,
    # static vs adaptive
    spec = api.parse_topology("torus:4x8")
    g = api.build_topology(spec, device=device)
    cl_s, cl_a = _clusters(g)
    t0 = time.perf_counter()
    s = netsim.collective_bench(cl_s, "alltoall", NBYTES)
    a = netsim.collective_bench(cl_a, "alltoall", NBYTES)
    wall = time.perf_counter() - t0
    rows.add("torus_alltoall", wall,
             f"static={s:.3g}s adaptive={a:.3g}s ratio={s / a:.3f}")
    results.append({
        "key": "torus_alltoall", "topology": g.name,
        "pattern": "alltoall", "nbytes": NBYTES, "seed": SEED,
        "static_s": s, "adaptive_s": a,
        "adaptive_vs_static": round(s / a, 4),
        "spec": json.loads(spec.to_json()),
    })
    return rows
