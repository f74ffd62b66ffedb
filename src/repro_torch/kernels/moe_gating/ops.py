"""MoE gating wrapper: the CUDA kernel (``moe_gating.cu``) on a CUDA
tensor, the plain version (``ref.py``) on a CPU tensor.  Counterpart of
``repro.kernels.moe_gating.moe_gating.moe_gating``.  It has no backward:
a router that needs a gradient through it is refused, never handed a
silent zero gradient."""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gating.ref import moe_gating_ref

MAX_EXPERTS = 128          # four register slots of a 32-lane warp
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = [build.P, build.P, build.P, build.I, build.I, build.I, build.I, build.P]


def moe_gating(logits: torch.Tensor, top_k: int):
    """logits (t, E) f32/bf16, E <= 128 -> (weights (t, E) f32: softmax
    over the top_k selected experts, zero elsewhere; mask (t, E) int32)."""
    if logits.dim() != 2:
        raise ValueError(f"moe_gating takes (tokens, experts); got {tuple(logits.shape)}")
    t, e = logits.shape
    if e > MAX_EXPERTS:
        raise ValueError(f"moe_gating holds at most {MAX_EXPERTS} experts "
                         f"in a warp's registers; got E={e}")
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k must be in [1, {e}]; got {top_k}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"moe_gating takes f32/bf16 logits; got {logits.dtype}")
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError("moe_gating has no backward: the router logits need "
                           "a gradient (MoE training is not ported, ROADMAP)")
    if logits.device.type == "cpu":
        return moe_gating_ref(logits, top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating runs on CUDA or CPU tensors; got "
                         f"{logits.device}")
    x = logits.contiguous()
    w = torch.empty((t, e), dtype=torch.float32, device=x.device)
    m = torch.empty((t, e), dtype=torch.int32, device=x.device)
    build.launch("repro_moe_gating", _ARGS, x.device, x.data_ptr(), w.data_ptr(),
                 m.data_ptr(), t, e, top_k, _DTYPES[x.dtype])
    moe_gating.launches += 1
    return w, m


moe_gating.launches = 0
