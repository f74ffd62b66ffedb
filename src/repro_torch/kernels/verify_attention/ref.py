"""Plain PyTorch verify attention over a T-token window, dense and paged:
the CPU path and the kernel's oracle.

Same masking as the Pallas kernel (``verify_attention.py:_verify_kernel``),
not as its ``ref.py`` oracle: row r = t * G + g of a (B, Hkv, T * G, D)
query block attends keys <= pos + r // G, scores past that limit are
-0.7 * f32max, V rows past the window's last position pos + T - 1 are
zeroed (fresh growth pages hold garbage and 0 * NaN would poison the
sum), and a zero softmax sum finalizes as 1.  The reference oracle masks
with -1e30 and a plain softmax instead; on finite inputs the two agree to
rounding (tests/test_torch_spec_decode.py states how far)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import MASK_VALUE, gather_pages


def _group(rows: int, t_window: int) -> int:
    if t_window < 1 or rows % t_window:
        raise ValueError(f"q rows {rows} not a multiple of t_window={t_window}")
    return rows // t_window


def verify_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, t_window: int) -> torch.Tensor:
    """q (B, Hkv, T*G, D), rows t-major; k/v (B, S, Hkv, D); pos (B,) first
    window position.  Returns (B, Hkv, T*G, D) in q.dtype."""
    b, hkv, tg, d = q.shape
    group = _group(tg, t_window)
    s_len = k.shape[1]
    pos = pos.to(device=q.device, dtype=torch.long)
    ki = torch.arange(s_len, device=q.device)
    limit = pos[:, None] + torch.arange(tg, device=q.device)[None, :] // group
    live = (ki[None, None, :] <= limit[:, :, None])[:, None]       # (B, 1, TG, S)
    s = torch.einsum("bhrd,bkhd->bhrk", q.float(), k.float()) * (d ** -0.5)
    s = torch.where(live, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    in_window = ki[None, :] <= (pos + t_window - 1)[:, None]       # (B, S)
    vf = torch.where(in_window[:, :, None, None], v.float(), 0.0)
    o = torch.einsum("bhrk,bkhd->bhrd", p, vf) / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype)


def paged_verify_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, block_tables: torch.Tensor,
                               pos: torch.Tensor, t_window: int, *,
                               k_scales: Optional[torch.Tensor] = None,
                               v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Hkv, T*G, D); pages (P, page_size, Hkv, D); block_tables
    (B, NB); pos (B,); int8 pages with ``k_scales``/``v_scales``
    (P, page_size) are dequantized before attending.  Returns
    (B, Hkv, T*G, D)."""
    return verify_attention_ref(q, gather_pages(k_pages, block_tables, k_scales),
                                gather_pages(v_pages, block_tables, v_scales), pos,
                                t_window)
