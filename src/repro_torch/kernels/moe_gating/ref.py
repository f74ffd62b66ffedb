"""Plain PyTorch MoE top-k gating, two ways.

``moe_gating_ref`` is the reference's ``_gating_kernel``
(``repro/kernels/moe_gating/moe_gating.py:26``) step by step: k rounds of
row max -> ``==`` -> first hit by cumsum -> -1e30 written into the hit
lane; then the softmax over the selected experts.  The lowest expert id
wins ties, and the -1e30 sentinel stays in the selected lanes, so a row
with fewer than k values above -1e30 selects fewer than k experts, as the
kernel does.  A row holding a NaN selects nothing (its max is NaN and
equals no lane) and gets NaN weights: the Pallas kernel's rule, not its
``lax.top_k`` oracle's, which selects the NaN lane.  Not ``torch.topk``,
which fixes no order among ties.  The wrapper's CPU path.

``moe_gating_rank_ref`` is the closed form of those rounds, which the
CUDA kernel computes: each expert's rank in the order (value descending,
id ascending) is the count of experts that beat it, and with
n = #{x > -1e30}:

- a row holding a NaN selects nothing;
- n >= k: rank < k;
- 1 <= n < k: every x > -1e30, and the lowest id g with x == -1e30 if g
  is below every id already selected (later rounds re-hit a sentinel);
- n = 0: one expert, the lowest id of the row's max.

The tests and the smoke run hold it equal to ``moe_gating_ref`` bit for
bit; no path calls it.
"""

from __future__ import annotations

import torch

NEG = -1e30   # the kernel's mask-out value


def _softmax_over(x: torch.Tensor, selected: torch.Tensor):
    """Softmax of f32 ``x`` over the ``selected`` lanes, as the Pallas
    kernel takes it (0 / 0 = NaN where nothing is selected)."""
    masked = torch.where(selected, x, NEG)
    p = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
    p = torch.where(selected, p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True)
    return p, selected.to(torch.int32)


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
    return _softmax_over(x, selected)


def moe_gating_rank_ref(logits: torch.Tensor, top_k: int):
    """The same function as :func:`moe_gating_ref` by rank counts, with no
    dependent rounds: logits (t, E) f32/bf16 -> (weights, mask)."""
    x = logits.float()
    ids = torch.arange(x.shape[-1], device=x.device)
    xi, xj = x.unsqueeze(-1), x.unsqueeze(-2)
    # beats[..., i, j]: expert j comes before expert i (a NaN beats no one)
    beats = (xj > xi) | ((xj == xi) & (ids < ids[:, None]))
    rank = beats.sum(dim=-1)
    above = x > NEG
    n = above.sum(dim=-1, keepdim=True)
    first_above = torch.where(above, ids, x.shape[-1]).amin(dim=-1, keepdim=True)
    short = (rank < n) | ((rank == n) & ((n == 0) | ((x == NEG) & (ids < first_above))))
    selected = torch.where(n >= top_k, rank < top_k, short)
    selected = selected & ~x.isnan().any(dim=-1, keepdim=True)
    return _softmax_over(x, selected)
