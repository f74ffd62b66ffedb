"""Matmul wrapper: the CUDA kernel (``matmul.cu``) on CUDA tensors, the
plain version (``ref.py``) on CPU tensors.  Counterpart of
``repro.kernels.matmul.matmul.matmul``."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.matmul.ref import matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 2 ** 31 - 1
_ARGS = [build.P, build.P, build.P, build.I, build.I, build.I, build.I, build.P]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) with f32 accumulation, output in a's dtype."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul takes (M, K) and (K, N); got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul kernel takes f32/bf16 a and b of one dtype; got "
                        f"{a.dtype}, {b.dtype}")
    if b.device != a.device:
        raise ValueError("a and b must share a device")
    (m, k), n = a.shape, b.shape[1]
    if max(m, n, k) > _MAX_DIM:
        raise ValueError(f"matmul kernel indexes dims with 32-bit ints; got {m}, {k}, {n}")
    a, b = a.contiguous(), b.contiguous()
    c = torch.empty(m, n, dtype=a.dtype, device=a.device)
    build.launch("repro_matmul", _ARGS, a.device, a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), m, n, k, _DTYPES[a.dtype])
    matmul.launches += 1
    return c


matmul.launches = 0
