"""Paper Fig 2 with the port: node-to-node ping-pong latency vs hop distance,
linear fit T = T0 + a*h with Pearson rho (the counterpart of
``benchmarks/fig2_pingpong.py``)."""
from repro_torch import api

from . import torch_common as common


def run(device=None) -> common.Rows:
    rows = common.Rows("fig2")
    exp = api.run_experiment(
        {**api.paper_suite("16"), **api.paper_suite("32")},
        workloads=[("pingpong_fit", {"nbytes": 1024})],
        cache_dir=common.CACHE_DIR, device=device)
    for name in exp.names:
        fit = exp.values[name]["pingpong_fit"]
        rows.add(name, exp.seconds[name]["pingpong_fit"],
                 f"T={fit['T0']*1e6:.2f}+{fit['alpha']*1e6:.2f}h rho={fit['rho']:.4f}")
    return rows
