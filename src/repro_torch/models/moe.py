"""Mixture-of-Experts layer: top-k gating through the ``moe_gating`` kernel
and the reference's grouped capacity dispatch.

Counterpart of ``repro.models.moe`` for serving.  Each group (one
sequence, or ``cfg.moe_group_size`` tokens of one) gives every expert
C = max(int(S * top_k * cf / E), 1) slots; a token's position in its
expert's buffer is the running count of the group's earlier tokens that
chose the expert, and tokens past C are dropped.  Dispatch and combine are
the reference's dense one-hot products (B, S, E, C), so a non-finite
hidden state poisons its own group's output (0 x NaN) and only that group,
as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gating.ops import moe_gating
from repro_torch.kernels.moe_gating.ref import moe_gating_ref
from repro_torch.models.layers import dense_init


def gating_topk(logits: torch.Tensor, top_k: int, use_kernel: bool = True):
    """logits (..., E) -> (weights (..., E) f32, mask (..., E) bool): k
    rounds of max-extract (lowest expert id wins ties), softmax over the
    selected experts.  The reference's ``gating_topk`` computes the same
    function in jnp; the port calls the kernel wrapper (its plain version
    on CPU tensors), or the plain version on any device when
    ``use_kernel`` is False."""
    shape = logits.shape
    fn = moe_gating if use_kernel else moe_gating_ref
    w, m = fn(logits.reshape(-1, shape[-1]), top_k)
    return w.reshape(shape), m.reshape(shape).bool()


def init_moe_params(gen: torch.Generator, cfg, *, device, dtype) -> dict:
    """One layer's router (d, E) and experts' SwiGLU weights (E, d, f),
    (E, f, d), with the reference's distributions."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    scale = (2.0 / (d + f)) ** 0.5

    def experts(*shape):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    return {"router": dense_init(gen, d, e, device=device, dtype=dtype),
            "w_gate": experts(e, d, f), "w_up": experts(e, d, f),
            "w_down": experts(e, f, d)}


def moe_block(params, x: torch.Tensor, cfg, *,
              capacity_factor: Optional[float] = None,
              use_kernel: bool = True) -> torch.Tensor:
    """x (B, S, d), B the group axis (one group per sequence).  With
    ``cfg.moe_group_size = g > 0`` and S a multiple of g above it, each
    sequence is split into groups of g tokens before dispatch (GShard
    grouping: the dispatch tensor grows linearly in S)."""
    b, s, d = x.shape
    g = cfg.moe_group_size
    if g and s > g and s % g == 0:
        y = _moe_dispatch(params, x.reshape(b * (s // g), g, d), cfg,
                          capacity_factor, use_kernel)
        return y.reshape(b, s, d)
    return _moe_dispatch(params, x, cfg, capacity_factor, use_kernel)


def _moe_dispatch(params, x: torch.Tensor, cfg, capacity_factor: Optional[float],
                  use_kernel: bool) -> torch.Tensor:
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    cap = max(int(s * k * cf / e), 1)
    dt = x.dtype

    logits = x @ params["router"].to(dt)                          # (B, S, E)
    weights, mask = gating_topk(logits, k, use_kernel)
    # position of each token within its expert's capacity buffer
    pos_in_expert = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keep = mask & (pos_in_expert < cap)
    slots = torch.arange(cap, device=x.device)
    disp = (keep[..., None] & (pos_in_expert[..., None] == slots)).to(dt)  # (B,S,E,C)
    combine = disp * weights[..., None].to(dt)

    xe = torch.einsum("bsec,bsd->ebcd", disp, x)                  # (E, B, C, d)
    gate = torch.einsum("ebcd,edf->ebcf", xe, params["w_gate"].to(dt))
    up = torch.einsum("ebcd,edf->ebcf", xe, params["w_up"].to(dt))
    ye = torch.einsum("ebcf,efd->ebcd", F.silu(gate) * up, params["w_down"].to(dt))
    return torch.einsum("bsec,ebcd->bsd", combine, ye)
