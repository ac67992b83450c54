"""The port's layout annealer and elastic remesh (``repro_torch.core.layout``,
``repro_torch.runtime``) against the reference's (``repro.core.layout``,
``repro.runtime``), field by field with ``device="cpu"``, and the checks of
``tests/test_layout_runtime.py`` on the port.

Tolerances: none.  The annealer draws from the same ``default_rng(seed)`` in
the same order and sums the same float64 terms in the same order, and the
port's ``apsp`` (the sweep's plain version) equals the reference's, so every
perm, cost, mesh shape and device order is compared exactly."""
import numpy as np
import pytest
import torch

from repro.core import graphs as ref_graphs
from repro.core import layout as ref_layout
from repro import runtime as ref_runtime
from repro_torch.core import graphs, layout, metrics
from repro_torch.runtime import (FailureDetector, StragglerPolicy, plan_elastic_remesh,
                                 surviving_subgraph)
from repro_torch.runtime import failures


def _pair(fn, *args):
    """The same constructor from both packages."""
    return getattr(graphs, fn)(*args), getattr(ref_graphs, fn)(*args)


@pytest.mark.parametrize("shape,bytes_", [((4, 4), (1.0, 2.0)), ((16, 16), (1.0, 8.0)),
                                          ((2, 3, 4), (1.0, 0.0, 3.0)), ((8,), (1.0,)),
                                          ((1, 5), (2.0, 1.0)), ((64, 64), (1.0, 8.0))])
def test_mesh_traffic_equals_reference(shape, bytes_):
    t = layout.mesh_traffic(shape, bytes_)
    assert t.dtype == np.float64
    np.testing.assert_array_equal(t, ref_layout.mesh_traffic(shape, bytes_))


def test_mesh_traffic_structure():
    t = layout.mesh_traffic((4, 4), (1.0, 2.0))
    assert t.shape == (16, 16)
    assert np.allclose(t, t.T)
    assert t[0].sum() == pytest.approx(2 * 1.0 + 2 * 2.0)


def _same_layout(res, ref):
    assert res.perm.tolist() == ref.perm.tolist()
    assert (res.cost, res.identity_cost, res.iterations) == \
        (ref.cost, ref.identity_cost, ref.iterations)
    assert res.improvement == ref.improvement


@pytest.mark.parametrize("fn,args,shape,bytes_,seed,n_iter", [
    ("torus", ([4, 4],), (4, 4), (1.0, 1.0), 0, 3000),
    ("ring", (16,), (4, 4), (1.0, 8.0), 1, 6000),
    ("wagner", (16,), (4, 4), (1.0, 3.0), 0, 2000),
    ("torus", ([16, 16],), (16, 16), (1.0, 8.0), 0, 400),
])
def test_optimize_layout_equals_reference(fn, args, shape, bytes_, seed, n_iter):
    g, rg = _pair(fn, *args)
    tr = layout.mesh_traffic(shape, bytes_)
    res = layout.optimize_layout(g, tr, seed=seed, n_iter=n_iter, device="cpu")
    _same_layout(res, ref_layout.optimize_layout(rg, tr, seed=seed, n_iter=n_iter))
    assert sorted(res.perm.tolist()) == list(range(g.n))
    hops = metrics.apsp(g, device="cpu")
    assert res.cost == pytest.approx(layout.layout_cost(tr, hops, res.perm))
    assert layout.layout_cost(tr, hops, res.perm) == ref_layout.layout_cost(tr, hops, res.perm)


def test_optimize_layout_on_a_searched_256_node_graph():
    """A 256-node graph of random circulant offsets, 16x16 mesh traffic,
    1500 iterations: the same perm and costs."""
    g = graphs.circulant(256, [1, 7, 31, 101])
    rg = ref_graphs.from_edges(256, g.edges, g.name)
    tr = layout.mesh_traffic((16, 16), (1.0, 8.0))
    res = layout.optimize_layout(g, tr, seed=3, n_iter=1500, device="cpu")
    _same_layout(res, ref_layout.optimize_layout(rg, tr, seed=3, n_iter=1500))
    assert res.improvement > 0


def test_layout_identity_optimal_on_matching_torus():
    g = graphs.torus([4, 4])
    tr = layout.mesh_traffic((4, 4), (1.0, 1.0))
    res = layout.optimize_layout(g, tr, seed=0, n_iter=3000, device="cpu")
    assert res.cost == pytest.approx(res.identity_cost)


def test_optimize_layout_refuses_bad_input():
    with pytest.raises(ValueError, match="traffic must be"):
        layout.optimize_layout(graphs.ring(8), np.zeros((4, 4)), device="cpu")
    two = graphs.from_edges(4, [(0, 1), (2, 3)])
    with pytest.raises(ValueError, match="disconnected"):
        layout.optimize_layout(two, np.zeros((4, 4)), device="cpu")


def test_failure_detector_and_straggler_policy():
    for mod in (failures, ref_runtime.failures):
        fd = mod.FailureDetector(n_nodes=4, timeout_s=5.0)
        for i in range(4):
            fd.heartbeat(i, t=100.0)
        fd.heartbeat(2, t=104.0)
        assert fd.dead(now=106.0) == [0, 1, 3]
        assert fd.dead(now=104.5) == []
        assert mod.FailureDetector(n_nodes=2).dead(now=0.0) == [0, 1]
    fd = FailureDetector(n_nodes=2, timeout_s=1.0)
    fd.heartbeat(0)
    assert 0 not in fd.dead()
    import dataclasses

    assert dataclasses.asdict(StragglerPolicy()) == \
        dataclasses.asdict(ref_runtime.StragglerPolicy())
    with pytest.raises(dataclasses.FrozenInstanceError):
        StragglerPolicy().factor = 2.0


@pytest.mark.parametrize("fn,args,dead", [("torus", ([4, 4],), [0, 5]),
                                          ("torus", ([4, 8],), [1, 9, 20]),
                                          ("ring", (8,), [0, 4]),
                                          ("ring", (8,), [2, 4])])
def test_surviving_subgraph_equals_reference(fn, args, dead):
    g, rg = _pair(fn, *args)
    sub, alive = surviving_subgraph(g, dead)
    rsub, ralive = ref_runtime.surviving_subgraph(rg, dead)
    assert (sub.n, sub.edges, sub.name, alive) == (rsub.n, rsub.edges, rsub.name, ralive)
    assert not set(alive) & set(dead)


@pytest.mark.parametrize("n,axes", [(1, 2), (3, 1), (29, 2), (253, 2), (8128, 2), (100, 3)])
def test_largest_mesh_equals_reference(n, axes):
    assert failures._largest_mesh(n, axes) == ref_runtime.failures._largest_mesh(n, axes)


def _same_plan(plan, ref):
    assert plan.mesh_shape == ref.mesh_shape
    assert [int(v) for v in plan.device_order] == [int(v) for v in ref.device_order]
    assert plan.dropped == ref.dropped
    assert (plan.layout_cost, plan.layout_improvement, plan.connected) == \
        (ref.layout_cost, ref.layout_improvement, ref.connected)


@pytest.mark.parametrize("fn,args,dead,axis_bytes,iters", [
    ("torus", ([4, 8],), [1, 9, 20], (1.0, 4.0), 1500),
    ("ring", (8,), [0, 4], (1.0,), 300),          # two components: vertex 0's kept
    ("ring", (8,), [2, 4], (1.0, 8.0), 300),      # survivor 3 isolated
    ("ring", (8,), [1, 7], (1.0, 8.0), 300),      # survivor 0 isolated: a 1-node plan
    ("wagner", (16,), [3], (1.0, 8.0), 800),
])
def test_plan_elastic_remesh_equals_reference(fn, args, dead, axis_bytes, iters):
    g, rg = _pair(fn, *args)
    plan = plan_elastic_remesh(g, dead, axis_bytes=axis_bytes, layout_iters=iters,
                               device="cpu")
    _same_plan(plan, ref_runtime.plan_elastic_remesh(rg, dead, axis_bytes=axis_bytes,
                                                     layout_iters=iters))
    assert np.prod(plan.mesh_shape) == len(plan.device_order)
    assert not set(plan.device_order) & set(dead)
    assert len(set(plan.device_order)) == len(plan.device_order)
    assert plan.connected


def test_disconnected_fallback_keeps_vertex_zeros_component():
    """Survivors {1, 2, 3} and {5, 6, 7}: the reference keeps the component
    of the first survivor (old id 1), not the largest; here both have 3."""
    plan = plan_elastic_remesh(graphs.ring(8), dead=[0, 4], axis_bytes=(1.0,),
                               layout_iters=300, device="cpu")
    assert np.prod(plan.mesh_shape) <= 3
    assert set(plan.device_order) <= {1, 2, 3}
    assert plan.dropped == [0, 4, 5, 6, 7]
    # a larger component elsewhere is still dropped: survivors {1} and {3..7}
    small = plan_elastic_remesh(graphs.ring(8), dead=[0, 2], axis_bytes=(1.0,),
                                layout_iters=50, device="cpu")
    assert small.mesh_shape == (1,) and small.device_order == [1]


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graphs.torus([4, 4])
    with pytest.raises(RuntimeError, match="CUDA"):
        layout.optimize_layout(g, layout.mesh_traffic((4, 4), (1.0, 1.0)), n_iter=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_elastic_remesh(g, dead=[0], layout_iters=10)
