"""Plain PyTorch MoE top-k gating: the reference's ``_gating_kernel``
(``repro/kernels/moe_gating/moe_gating.py:26``) step by step.

k rounds of row max -> ``==`` -> first hit by cumsum -> -1e30 written into
the hit lane; then the softmax over the selected experts.  The lowest
expert id wins ties, and the -1e30 sentinel stays in the selected lanes,
so a row with fewer than k values above -1e30 selects fewer than k
experts, as the kernel does.  A row holding a NaN selects nothing (its
max is NaN and equals no lane) and gets NaN weights: the Pallas kernel's
rule, not its ``lax.top_k`` oracle's, which selects the NaN lane.  Not
``torch.topk``, which fixes no order among ties.
"""

from __future__ import annotations

import torch

NEG = -1e30   # the kernel's mask-out value


def moe_gating_ref(logits: torch.Tensor, top_k: int):
    """logits (t, E) f32/bf16 -> (weights (t, E) f32, mask (t, E) int32)."""
    x = logits.float()
    remaining = x
    selected = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(top_k):
        mx = remaining.amax(dim=-1, keepdim=True)      # NaN propagates
        hit = remaining == mx
        hit = hit & (torch.cumsum(hit.to(torch.int32), dim=-1) == 1)
        selected = selected | hit
        remaining = torch.where(hit, NEG, remaining)
    masked = torch.where(selected, x, NEG)
    p = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
    p = torch.where(selected, p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True)
    return p, selected.to(torch.int32)
