"""MSE wrappers: the CUDA kernel (``mse.cu``) on CUDA tensors, the plain
version (``ref.py``) on CPU tensors.  ``mse_partial_sum`` is the
counterpart of ``repro.kernels.mse.mse.mse_partial_sum``, ``mse`` of the
reference's mean wrapper ``mse_op``."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mse.ref import mse_partial_sum_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [build.P, build.P, build.P, build.I64, build.I, build.I, build.P]


def mse_partial_sum(pred: torch.Tensor, target: torch.Tensor, *,
                    warp_size: int = 32) -> torch.Tensor:
    """Sum of squared errors over all elements, as a 0-d f32 tensor; the
    shfl_down tree runs over ``warp_size``-lane rows (a power of two that
    divides the element count, as the reference requires)."""
    n = pred.numel()
    if target.shape != pred.shape:
        raise ValueError(f"pred {tuple(pred.shape)} and target {tuple(target.shape)} differ")
    if warp_size < 1 or warp_size & (warp_size - 1) or n % warp_size:
        raise ValueError(f"warp_size must be a power of two dividing {n} "
                         f"(pad inputs to a warp multiple); got {warp_size}")
    if pred.device.type == "cpu":
        return mse_partial_sum_ref(pred, target, warp_size)
    if pred.dtype not in _DTYPES or target.dtype != pred.dtype:
        raise TypeError(f"mse kernel takes f32/bf16 pred and target of one dtype; "
                        f"got {pred.dtype}, {target.dtype}")
    if target.device != pred.device:
        raise ValueError("pred and target must share a device")
    p, t = pred.contiguous(), target.contiguous()
    out = torch.empty((), dtype=torch.float32, device=p.device)
    build.launch("repro_mse_partial_sum", _ARGS, p.device, p.data_ptr(), t.data_ptr(),
                 out.data_ptr(), n, min(warp_size, 32), _DTYPES[p.dtype])
    mse_partial_sum.launches += 1
    return out


def mse(pred: torch.Tensor, target: torch.Tensor, warp_size: int = 32) -> torch.Tensor:
    """Mean squared error (f32): the kernel's partial sum over the count."""
    return mse_partial_sum(pred.reshape(-1), target.reshape(-1),
                           warp_size=warp_size) / pred.numel()


mse_partial_sum.launches = 0
