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


def flash_decode_split_emulated(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                pos: torch.Tensor, splits: int) -> torch.Tensor:
    """A plain emulation of the split kernel's partials and the combine
    pass (``decode_attention.cu``), for the tests; no path calls it.  A
    row with n = min(pos + 1, S) live keys takes ``split_keys(n, splits)``
    keys a split; rows past n are zeros (the kernel's zero fill), scored
    MASK_VALUE and weighted 0.  Each used split s gives m_s, l_s and acc_s
    over its own keys; the combine takes M = max m_s and sums exp(m_s - M)
    acc_s and exp(m_s - M) l_s in split order, a zero sum finalizing as 1.
    Same shapes as :func:`flash_decode_ref`."""
    from repro_torch.kernels.decode_attention.ops import split_keys

    b, s_len = k.shape[0], k.shape[1]
    t = torch.arange(s_len, device=q.device)
    n = (pos.to(q.device).long() + 1).clamp(0, s_len)                  # (B,)
    chunk = torch.tensor([split_keys(int(x), splits) for x in n], device=q.device)
    used = (n + chunk - 1) // chunk
    live = t[None, :] < n[:, None]                                     # (B, S)
    kf = torch.where(live[:, :, None, None], k.float(), 0.0)
    vf = torch.where(live[:, :, None, None], v.float(), 0.0)
    sc = torch.einsum("bhgd,bkhd->bhgk", q.float(), kf) * (q.shape[-1] ** -0.5)
    sc = torch.where(live[:, None, None, :], sc, MASK_VALUE)
    parts = []
    for s in range(splits):
        mine = live & (t[None, :] // chunk[:, None] == s)              # (B, S)
        sel = mine[:, None, None, :]
        m = torch.where(sel, sc, -torch.inf).amax(-1, keepdim=True)
        p = torch.where(sel, torch.exp(sc - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum("bhgk,bkhd->bhgd", p, vf)))
    on = [(s < used)[:, None, None, None] for s in range(splits)]
    big = torch.stack([torch.where(u, m, -torch.inf) for u, (m, _, _) in zip(on, parts)]).amax(0)
    l_sum = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for u, (m, l, a) in zip(on, parts):
        f = torch.where(u, torch.exp(m - big), 0.0)
        l_sum = l_sum + f * l
        acc = acc + f * a
    return (acc / torch.where(l_sum == 0.0, 1.0, l_sum)).to(q.dtype)


def paged_flash_decode_split_emulated(q: torch.Tensor, k_pages: torch.Tensor,
                                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                                      pos: torch.Tensor, splits: int, *,
                                      k_scales: Optional[torch.Tensor] = None,
                                      v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`flash_decode_split_emulated` over the pages' rows (n_keys_max
    = NB * page_size).  The kernel clamps its page lookup at pos's block;
    every row it reads lies at or before it, where the clamp changes
    nothing, and the emulation zeroes the rest."""
    return flash_decode_split_emulated(
        q, gather_pages(k_pages, block_tables, k_scales),
        gather_pages(v_pages, block_tables, v_scales), pos, splits)
