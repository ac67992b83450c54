"""Fault-tolerance demo with the port: train, kill nodes mid-run, re-plan
the mesh on the surviving topology (the paper's layout optimization over
``core.layout``, its distances on the device), restore the checkpoint resharded onto a
mesh, continue training (the port's copy of ``examples/elastic_failover.py``).

The card's machine has one GPU, so the restored run's mesh is a
world-size-1 ("data", "model") mesh: the checkpoint's full tensors are
placed onto it by ``ckpt.restore(shardings=...)`` (the elastic-rescale
path).  Runs on the CUDA device unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_elastic_failover.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config, reduced_config
from repro_torch.core import graphs
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import local_world, make_test_mesh
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.runtime import FailureDetector, plan_elastic_remesh
from repro_torch.train import Trainer


def run(device=None, out=print) -> Trainer:
    """The demo; returns the restored trainer."""
    cfg = reduced_config(get_config("qwen3-32b"))
    model = build_model(cfg, device=device)
    opt = make_optimizer("adamw", lr=1e-3, total_steps=100, warmup=2)
    data = SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=8, seed=0))
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(model=model, opt=opt, data=data, ckpt_dir=d, ckpt_every=5)
        tr.init()
        tr.train(10, log_every=5, log_fn=out)
        out("\n--- simulating failure of nodes 3, 12, 17 in a (4,8) torus fleet ---")
        fleet = graphs.torus([4, 8])
        fd = FailureDetector(n_nodes=32, timeout_s=10)
        for i in range(32):
            fd.heartbeat(i, t=0.0 if i in (3, 12, 17) else 100.0)
        dead = fd.dead(now=105.0)
        out(f"failure detector reports dead: {dead}")
        plan = plan_elastic_remesh(fleet, dead, axis_bytes=(1e6, 8e6), layout_iters=3000,
                                   device=model.device)
        out(f"remesh plan: shape {plan.mesh_shape}, layout improvement "
            f"{plan.layout_improvement:.1%}, survivors used: {len(plan.device_order)}")
        with local_world(model.device.type):
            mesh = make_test_mesh((1, 1), ("data", "model"), device=model.device.type)
            tr2 = Trainer(model=build_model(cfg, mesh=mesh), opt=opt,
                          data=SyntheticLM(cfg, DataConfig(seq_len=32, global_batch=8, seed=0)),
                          ckpt_dir=d)
            assert tr2.restore()
            out(f"restored at step {int(tr2.state['step'])}, data step {tr2.data.step}; "
                f"resuming")
            tr2.train(5, log_every=5, log_fn=out)
    out("elastic failover complete")
    return tr2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default=None,
                   help="'cpu' for the kernels' plain versions (default: the CUDA device)")
    run(p.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
