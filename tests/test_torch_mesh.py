"""The port's meshes (``repro_torch.launch.mesh``): the paper's pod order
against the reference's, the production mesh's rank arithmetic and its
refusals, and the CUDA default with no silent CPU mesh."""
import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import mesh as jmesh
from repro_torch.configs import get_config
from repro_torch.launch import mesh
from repro_torch.models import build_model


@pytest.mark.parametrize("n_pods", [3, 4, 8, 16])
def test_optimized_pod_order_equals_the_reference(n_pods):
    order, info = mesh.optimized_pod_order(n_pods, 4)
    j_order, j_info = jmesh.optimized_pod_order(n_pods, 4)
    assert order == j_order
    assert info == j_info


def test_device_order_permutes_the_ranks():
    perm = np.random.default_rng(0).permutation(512)
    got = mesh.mesh_ranks((2, 16, 16), perm)
    np.testing.assert_array_equal(got, np.arange(512)[perm].reshape(2, 16, 16))
    np.testing.assert_array_equal(mesh.mesh_ranks((16, 16)), np.arange(256).reshape(16, 16))
    with pytest.raises(ValueError, match="permutation"):
        mesh.mesh_ranks((16, 16), [0] * 256)


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank in this process."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def test_production_mesh_raises_below_its_ranks(world_of_one):
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        mesh.make_test_mesh((2, 2, 2), device="cpu")
    one = mesh.make_test_mesh((1, 1, 1), device="cpu")
    assert one.mesh_dim_names == ("pod", "data", "model") and one.device_type == "cpu"
    model = build_model(get_config("qwen3-32b"), mesh=one)
    assert model.device.type == "cpu" and model.mesh is one
    with pytest.raises(NotImplementedError, match="item 21"):
        build_model(get_config("mamba2-2.7b"), mesh=one)
    with pytest.raises(ValueError, match="differs from the mesh"):
        build_model(get_config("qwen3-32b"), mesh=one, device="cuda")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_default_mesh_device_is_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_test_mesh((1, 1, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_production_mesh()


def test_mesh_needs_a_process_group():
    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_test_mesh((1, 1, 1), device="cpu")
