"""The port's device rule, shared by every entry point: CUDA unless the
caller names another device (``device="cpu"`` runs the plain PyTorch
versions of the kernels)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a `torch.device`; ``None`` means CUDA, and raises when
    no CUDA device is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA and no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions of the kernels")
    return torch.device("cuda")
