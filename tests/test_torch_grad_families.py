"""Gradients of the port's ``Model.loss`` for the vlm, ssm, hybrid and
encdec families, float32, on the CPU, against ``jax.grad`` of the
reference's loss (``tests/test_torch_grad.py`` holds the tolerances: 1e-4
a leaf, whisper-tiny's 5e-3, and the dense and moe families)."""
import pytest

from test_torch_grad import check_gradients


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "mamba2-2.7b", "zamba2-2.7b", "whisper-tiny"])
def test_gradients_match_jax_grad(arch):
    check_gradients(arch)
