"""RMSNorm wrapper: the CUDA kernel (``rmsnorm.cu``) on a CUDA tensor, the
plain version (``ref.py``) on a CPU tensor.  Counterpart of
``repro.kernels.rmsnorm.rmsnorm.rmsnorm``; :class:`RMSNorm` is
``repro.kernels.rmsnorm.ops``'s ``custom_vjp`` around it."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [build.P, build.P, build.P, build.I, build.I, build.F, build.I, build.I,
         build.I, build.P]
# the warp branch: rows of whole 16-byte vectors, at most 64 floats a lane
_VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8}
MAX_WARP_WIDTH = 2048


def takes_warp_branch(x2: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the kernel's one-warp-a-row branch takes these (n, d) rows:
    d a multiple of the 16-byte vector and at most ``MAX_WARP_WIDTH``, x
    and w 16-byte aligned.  Anything else takes the block-per-row ragged
    branch."""
    d = x2.shape[-1]
    return (d % _VEC_ELEMS[x2.dtype] == 0 and d <= MAX_WARP_WIDTH
            and x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), w (d,) -> (..., d) in x.dtype.  x and w are f32 or bf16,
    each on its own (fp32 master weights under bf16 rows); the weight is
    multiplied in fp32.  On a CUDA tensor the kernel's warp branch runs
    where :func:`takes_warp_branch` allows, else its ragged branch; each
    counts its own launches."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes f32/bf16 x and w; got "
                        f"{x.dtype}, {w.dtype}")
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"w must be ({d},) on {x.device}; got "
                         f"{tuple(w.shape)} on {w.device}")
    x2 = x.reshape(-1, d).contiguous()
    w = w.contiguous()
    y = torch.empty_like(x2)
    warp = takes_warp_branch(x2, w)
    build.launch("repro_rmsnorm", _ARGS, x.device, x2.data_ptr(),
                 w.data_ptr(), y.data_ptr(), x2.shape[0], d, float(eps),
                 _DTYPES[x.dtype], _DTYPES[w.dtype], int(not warp))
    if warp:
        rmsnorm.launches += 1
    else:
        rmsnorm.launches_ragged += 1
    return y.reshape(x.shape)


rmsnorm.launches = 0          # the warp branch
rmsnorm.launches_ragged = 0   # the block-per-row branch


class RMSNorm(torch.autograd.Function):
    """Differentiable RMSNorm (the reference's ``_rmsnorm_vjp``,
    ``rmsnorm/ops.py:20-43``).  Forward: the kernel.  Backward: the
    reference's closed form in fp32, plain torch, as there:
    dx = r * (g*w - u * mean(g*w*u)), dw = sum over rows of g*u."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xf, gf, wf = x.float(), g.float(), w.float()
        r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + ctx.eps)
        u = xf * r                                   # normalized rows
        gw = gf * wf
        dx = r * (gw - u * (gw * u).mean(-1, keepdim=True))
        dw = (gf * u).reshape(-1, x.shape[-1]).sum(0)
        return dx.to(x.dtype), dw.to(w.dtype), None


def rmsnorm_op(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm`, differentiable in x and w."""
    return RMSNorm.apply(x, w, eps)
