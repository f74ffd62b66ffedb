"""Plain PyTorch sum of squared errors: the CPU path and the CUDA kernel's
oracle.  It repeats the reference Pallas kernel's arithmetic (``mse.py``):
f32 squared error, a shfl_down tree per ``warp_size``-lane row that
leaves the row's sum in lane 0, then the sum of the lane-0 values."""

from __future__ import annotations

import torch


def mse_partial_sum_ref(pred: torch.Tensor, target: torch.Tensor,
                        warp_size: int = 32) -> torch.Tensor:
    d = pred.reshape(-1, warp_size).float() - target.reshape(-1, warp_size).float()
    v = d * d
    while v.shape[1] > 1:            # lane i += lane i + offset, lane 0's chain
        half = v.shape[1] // 2
        v = v[:, :half] + v[:, half:]
    return v[:, 0].sum()
