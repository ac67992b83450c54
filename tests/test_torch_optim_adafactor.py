"""Adafactor's update against the JAX package's on the same parameters,
gradients and state (``tests/test_torch_optim.py`` holds the rules: 4
float32 ulps for Adafactor's parameters, 2 for its state, 1 bf16 ulp),
also at a 16-layer config where the stacked 1-D leaves factor across the
layers."""
import pytest

from repro_torch.optim.optimizers import tree_get
from test_torch_optim import _run


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "whisper-tiny"])
def test_adafactor_update_matches_reference(arch, dtype):
    _run("adafactor", arch, dtype)


def test_adafactor_factors_stacked_1d_leaves_at_16_layers():
    """At 16 layers a stack of per-layer scales, (16, d), is factored: its
    row statistic spans the layers and its column statistic the width,
    and the update's RMS clip spans the whole stack, as the reference's."""
    cfg, leaves, state = _run("adafactor", "qwen3-32b", "float32", n_layers=16)
    ln1 = tree_get(state["stats"], "blocks/ln1")
    assert set(ln1) == {"vr", "vc"} and ln1["vr"].shape == (16,) and ln1["vc"].shape == (64,)
    assert set(tree_get(state["stats"], "final_norm")) == {"v"}
