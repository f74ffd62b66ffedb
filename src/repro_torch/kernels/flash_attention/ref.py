"""Plain PyTorch flash attention, forward and backward: materialized fp32
scores with the kernels' masking rules.  The CPU path and the kernels'
oracle."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

F32_MAX = torch.finfo(torch.float32).max
MASK_VALUE = -0.7 * F32_MAX          # flash_attention.py:45
FULLY_MASKED_LSE = 0.7 * F32_MAX     # flash_attention.py:48


def _live(sq: int, skv: int, kv_len: Optional[torch.Tensor], causal: bool,
          b: int, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(valid (B, 1, 1, Sq, Skv) bool: the score entries that are live,
    in_len (B, Skv) bool or None: the keys before kv_len)."""
    ki = torch.arange(skv, device=device)
    valid = torch.ones(sq, skv, dtype=torch.bool, device=device)
    if causal:
        valid = torch.arange(sq, device=device)[:, None] >= ki[None, :]
    in_len = None
    if kv_len is not None:
        in_len = ki[None, :] < kv_len.to(device)[:, None]             # (B, Skv)
        valid = valid[None] & in_len[:, None, :]                      # (B, Sq, Skv)
    else:
        valid = valid[None].expand(b, sq, skv)
    return valid[:, None, None], in_len


def _kv_rows(k: torch.Tensor, v: torch.Tensor, in_len: Optional[torch.Tensor]):
    """k, v in fp32 with the rows past kv_len zeroed, as the kernels never
    load them: whatever they hold (NaN included) cannot reach a sum."""
    kf, vf = k.float(), v.float()
    if in_len is not None:
        keep = in_len[:, :, None, None]
        kf, vf = torch.where(keep, kf, 0.0), torch.where(keep, vf, 0.0)
    return kf, vf


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[torch.Tensor] = None, *,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Sq, Hq, D); k (B, Skv, Hkv, D); v (B, Skv, Hkv, Dv); kv_len
    (B,) int.  Scores scale by D^-1/2.

    Returns (o (B, Sq, Hq, Dv) in q.dtype, lse (B, Hq, Sq) float32).
    Query head h attends KV head h // (Hq // Hkv).  Rows whose every key
    is masked get o = 0 and lse = FULLY_MASKED_LSE.  Differentiable in
    q, k, v through autograd (the plain path's training gradient)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    valid, in_len = _live(sq, skv, kv_len, causal, b, q.device)
    kf, vf = _kv_rows(k, v, in_len)
    qg = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * d ** -0.5
    s = torch.where(valid, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vf) / safe.permute(0, 3, 1, 2, 4)
    lse = torch.where(l == 0.0, FULLY_MASKED_LSE, m + torch.log(safe))[..., 0]
    return o.reshape(b, sq, hq, v.shape[-1]).to(q.dtype), lse.reshape(b, hq, sq)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor,
                            kv_len: Optional[torch.Tensor] = None, *,
                            causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, Sq, Hq, D); k (B, Skv, Hkv, D); v (B, Skv, Hkv, Dv); do (B, Sq,
    Hq, Dv); lse, delta (B, Hq, Sq) float32 (delta = rowsum(dO * O));
    kv_len (B,) int.

    Returns (dq (B, Sq, Hq, D), dk (B, Skv, Hkv, D), dv (B, Skv, Hkv,
    Dv)), all float32:
    p = exp(s - lse) rebuilt under the forward's masks (p := 0 where
    masked), ds = p * (dO.v - delta) * scale, dq = ds @ k, dk = ds^T @ q
    and dv = p^T @ dO, the last two summed over the G query heads of each
    KV head."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    valid, in_len = _live(sq, skv, kv_len, causal, b, q.device)
    kf, vf = _kv_rows(k, v, in_len)
    qg = q.float().reshape(b, sq, hkv, g, d)
    dog = do.float().reshape(b, sq, hkv, g, v.shape[-1])
    row = (b, hkv, g, sq, 1)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
    p = torch.where(valid, torch.exp(s - lse.float().reshape(row)), 0.0)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vf)
    ds = p * (dp - delta.float().reshape(row)) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    return dq, dk, dv
