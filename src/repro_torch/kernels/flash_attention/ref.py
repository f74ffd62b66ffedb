"""Plain PyTorch flash-attention forward: materialized fp32 scores with
the kernel's masking rules.  The CPU path and the kernel's oracle."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

F32_MAX = torch.finfo(torch.float32).max
MASK_VALUE = -0.7 * F32_MAX          # flash_attention.py:45
FULLY_MASKED_LSE = 0.7 * F32_MAX     # flash_attention.py:48


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None, *,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D); kv_len (B,) int.

    Returns (o (B, Sq, Hq, D) in q.dtype, lse (B, Hq, Sq) float32).
    Query head h attends KV head h // (Hq // Hkv).  Rows whose every key
    is masked get o = 0 and lse = FULLY_MASKED_LSE."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    ki = torch.arange(skv, device=q.device)
    valid = torch.ones(sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        valid = torch.arange(sq, device=q.device)[:, None] >= ki[None, :]
    if kv_len is not None:
        in_len = ki[None, :] < kv_len.to(q.device)[:, None]          # (B, Skv)
        valid = valid[None] & in_len[:, None, :]                      # (B, Sq, Skv)
    else:
        valid = valid[None].expand(b, sq, skv)
    valid = valid[:, None, None]                                      # (B,1,1,Sq,Skv)
    s = torch.where(valid, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()) / safe.permute(0, 3, 1, 2, 4)
    lse = torch.where(l == 0.0, FULLY_MASKED_LSE, m + torch.log(safe))[..., 0]
    return o.reshape(b, sq, hq, d).to(q.dtype), lse.reshape(b, hq, sq)
