"""Plain PyTorch decode attention, dense and paged: the CPU path and the
kernels' oracle.  Same masking as the kernels: keys past pos score
-0.7 * f32max, V rows past pos are zeroed (pages and tails may hold
garbage), and a zero softmax sum finalizes as 1."""

from __future__ import annotations

from typing import Optional

import torch

MASK_VALUE = -0.7 * torch.finfo(torch.float32).max   # decode_attention.py:39


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """q (B, Hkv, G, D); k/v (B, S, Hkv, D); pos (B,).  Keys at positions
    <= pos[b] are live.  Returns (B, Hkv, G, D) in q.dtype."""
    s_len = k.shape[1]
    live = (torch.arange(s_len, device=q.device)[None, :]
            <= pos.to(q.device)[:, None])                        # (B, S)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    s = torch.where(live[:, None, None, :], s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live[:, None, None, :], torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    vf = torch.where(live[:, :, None, None], v.float(), 0.0)
    o = torch.einsum("bhgk,bkhd->bhgd", p, vf) / torch.where(l == 0.0, 1.0, l)
    return o.to(q.dtype)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(P, ps, H, D) pages through (B, NB) tables -> dense (B, NB*ps, H, D),
    an ``index_select`` gather.  With int8 pages, ``scales`` (P, ps) are
    gathered through the same table and the rows come back dequantized
    in f32 (value * row scale), as the reference's jnp path."""
    b, nb = block_tables.shape
    flat = block_tables.reshape(-1).to(device=pages.device, dtype=torch.long)
    g = pages.index_select(0, flat)                          # (B*NB, ps, H, D)
    if scales is not None:
        g = g.float() * scales.index_select(0, flat)[..., None, None]
    return g.reshape(b, nb * pages.shape[1], *pages.shape[2:])


def paged_flash_decode_ref(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Hkv, G, D); pages (P, page_size, Hkv, D); block_tables (B, NB);
    pos (B,); int8 pages with ``k_scales``/``v_scales`` (P, page_size)
    are dequantized before attending.  Returns (B, Hkv, G, D)."""
    return flash_decode_ref(q, gather_pages(k_pages, block_tables, k_scales),
                            gather_pages(v_pages, block_tables, v_scales), pos)
