"""RMSNorm wrapper: the CUDA kernel (``rmsnorm.cu``) on a CUDA tensor, the
plain version (``ref.py``) on a CPU tensor.  Counterpart of
``repro.kernels.rmsnorm.rmsnorm.rmsnorm``."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [build.P, build.P, build.P, build.I, build.I, build.F, build.I, build.P]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), w (d,) -> (..., d) in x.dtype."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes f32/bf16 x with w of the same "
                        f"dtype; got {x.dtype}, {w.dtype}")
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"w must be ({d},) on {x.device}; got "
                         f"{tuple(w.shape)} on {w.device}")
    x2 = x.reshape(-1, d).contiguous()
    w = w.contiguous()
    y = torch.empty_like(x2)
    build.launch("repro_rmsnorm", _ARGS, x.device, x2.data_ptr(),
                 w.data_ptr(), y.data_ptr(), x2.shape[0], d, float(eps),
                 _DTYPES[x.dtype])
    rmsnorm.launches += 1
    return y.reshape(x.shape)


rmsnorm.launches = 0
