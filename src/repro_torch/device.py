"""Device resolution: the port runs on CUDA unless the caller asks for
the CPU, and never drifts onto the CPU by itself."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Asking for CUDA on a machine without it
    raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    return dev


def requires_cuda():
    """Skip the calling test unless a CUDA device is present.  Call it
    inside the test (never at import time or in a ``skipif``), so every
    pytest worker collects the same tests."""
    import pytest

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
