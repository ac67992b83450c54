"""Where the port runs: the CUDA device unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` is the CUDA device; without one it raises ``RuntimeError`` and
    never falls back to the CPU.  ``"cpu"`` (or a CPU ``torch.device``) is
    honoured as given: the kernels' plain PyTorch versions run there.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
