"""MoE gating wrapper: the CUDA kernel (``moe_gating.cu``) on a CUDA
tensor, the plain version (``ref.py``) on a CPU tensor.  Counterpart of
``repro.kernels.moe_gating.moe_gating.moe_gating``.

Where the logits need a gradient (training), the call goes through
:class:`MoEGating`, whose forward is that same kernel or plain version
and whose backward is the gradient of the reference's ``gating_topk``:
the mask is discrete, so the gradient flows only through the softmax
over the selected experts.  Serving runs under ``no_grad`` and meets no
``Function`` node."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gating.ref import moe_gating_ref

MAX_EXPERTS = 128          # four register slots of a 32-lane warp
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [build.P, build.P, build.P, build.I, build.I, build.I, build.I, build.P]


def _gate(logits: torch.Tensor, top_k: int):
    if logits.device.type == "cpu":
        return moe_gating_ref(logits, top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating runs on CUDA or CPU tensors; got "
                         f"{logits.device}")
    t, e = logits.shape
    x = logits.contiguous()
    w = torch.empty((t, e), dtype=torch.float32, device=x.device)
    m = torch.empty((t, e), dtype=torch.int32, device=x.device)
    build.launch("repro_moe_gating", _ARGS, x.device, x.data_ptr(), w.data_ptr(),
                 m.data_ptr(), t, e, top_k, _DTYPES[x.dtype])
    moe_gating.launches += 1
    return w, m


class MoEGating(torch.autograd.Function):
    """(weights, mask) of ``moe_gating`` with the weights differentiable
    in the logits.  The forward saves the f32 weights w and the mask; the
    backward of their gradient g is w * (g - sum_j w_j g_j) on the
    selected experts and 0 elsewhere, in f32, cast to the logits' dtype,
    the same torch formula on either device.  That is ``jax.grad`` of the
    reference's ``gating_topk`` (whose ``where`` zeroes the unselected
    lanes): a NaN row, which selects nothing, gets zeros; an all -inf row
    selects one expert, whose weight is NaN, and gets NaN there alone.
    The reference has no backward kernel for this function, so neither
    does the port."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, top_k: int):
        w, m = _gate(logits, top_k)
        ctx.save_for_backward(w, m)
        ctx.logits_dtype = logits.dtype
        ctx.mark_non_differentiable(m)
        return w, m

    @staticmethod
    def backward(ctx, gw, _gm):
        w, m = ctx.saved_tensors
        gw = gw.float()
        g = torch.where(m.bool(), w * (gw - (w * gw).sum(dim=-1, keepdim=True)), 0.0)
        return g.to(ctx.logits_dtype), None


def moe_gating(logits: torch.Tensor, top_k: int):
    """logits (t, E) f32/bf16, E <= 128 -> (weights (t, E) f32: softmax
    over the top_k selected experts, zero elsewhere; mask (t, E) int32).
    Differentiable in the logits where they need a gradient."""
    if logits.dim() != 2:
        raise ValueError(f"moe_gating takes (tokens, experts); got {tuple(logits.shape)}")
    e = logits.shape[1]
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_gating holds at most {MAX_EXPERTS} experts "
                         f"in a warp's registers; got E={e}")
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k must be in [1, {e}]; got {top_k}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"moe_gating takes f32/bf16 logits; got {logits.dtype}")
    if torch.is_grad_enabled() and logits.requires_grad:
        return MoEGating.apply(logits, top_k)
    return _gate(logits, top_k)


moe_gating.launches = 0
