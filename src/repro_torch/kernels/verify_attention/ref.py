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


def paged_flash_verify_split_emulated(q: torch.Tensor, k_pages: torch.Tensor,
                                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                                      pos: torch.Tensor, t_window: int, splits: int, *,
                                      k_scales: Optional[torch.Tensor] = None,
                                      v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A plain emulation of the split kernel's per-row partials and the
    combine pass (``decode_attention/split.cuh``) over a verify window, for
    the tests; no path calls it.  The window's n = min(pos + T, NB *
    page_size) live keys are cut into ``split_keys(n, splits)`` keys a
    split; rows past n are zeros (the kernel's zero fill).  Row r scores a
    live key past pos + r // G as MASK_VALUE with p = 0, so a split wholly
    past its limit leaves (m = MASK_VALUE, l = 0, acc = 0).  The combine
    takes M = max m_s over the window's used splits and sums exp(m_s - M)
    acc_s and exp(m_s - M) l_s in split order, a zero sum finalizing as
    1.  Same shapes as :func:`paged_verify_attention_ref`."""
    from repro_torch.kernels.decode_attention.ops import split_keys

    k = gather_pages(k_pages, block_tables, k_scales)
    v = gather_pages(v_pages, block_tables, v_scales)
    group = _group(q.shape[2], t_window)
    s_len = k.shape[1]
    t = torch.arange(s_len, device=q.device)
    pos = pos.to(q.device).long()
    n = (pos + t_window).clamp(0, s_len)                               # (B,)
    chunk = torch.tensor([split_keys(int(x), splits) for x in n], device=q.device)
    used = (n + chunk - 1) // chunk
    live = t[None, :] < n[:, None]                                     # (B, S)
    row_last = pos[:, None] + torch.arange(q.shape[2], device=q.device)[None, :] // group
    ok = live[:, None, :] & (t[None, None, :] <= row_last[:, :, None])  # (B, TG, S)
    ok = ok[:, None]                                                   # (B, 1, TG, S)
    kf = torch.where(live[:, :, None, None], k.float(), 0.0)
    vf = torch.where(live[:, :, None, None], v.float(), 0.0)
    sc = torch.einsum("bhrd,bkhd->bhrk", q.float(), kf) * (q.shape[-1] ** -0.5)
    sc = torch.where(ok, sc, MASK_VALUE)
    parts = []
    for s in range(splits):
        mine = (live & (t[None, :] // chunk[:, None] == s))[:, None, None, :]
        m = torch.where(mine, sc, -torch.inf).amax(-1, keepdim=True)
        p = torch.where(mine & ok, torch.exp(sc - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum("bhrk,bkhd->bhrd", p, vf)))
    on = [(s < used)[:, None, None, None] for s in range(splits)]
    big = torch.stack([torch.where(u, m, -torch.inf) for u, (m, _, _) in zip(on, parts)]).amax(0)
    l_sum = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for u, (m, l, a) in zip(on, parts):
        f = torch.where(u, torch.exp(m - big), 0.0)
        l_sum = l_sum + f * l
        acc = acc + f * a
    return (acc / torch.where(l_sum == 0.0, 1.0, l_sum)).to(q.dtype)


def paged_verify_attention_scale_fold_emulated(q: torch.Tensor, k_pages: torch.Tensor,
                                               v_pages: torch.Tensor,
                                               block_tables: torch.Tensor, pos: torch.Tensor,
                                               t_window: int, *, k_scales: torch.Tensor,
                                               v_scales: torch.Tensor) -> torch.Tensor:
    """For the tests only; no path calls it.  A plain emulation of the
    long-window branch's int8 arithmetic under bf16 q (the tensor-core
    tile in ``verify_attention.cu``): the int8 rows enter the products as
    integers and their row scales fold in after, the K scale into the
    score column, s_j = scale * (q . k8_j) * ks_j, and the V scale into P,
    o = sum_j (p_j * vs_j) v8_j / sum_j p_j, the row sum taking p_j
    unscaled.  :func:`paged_verify_attention_ref`, the kernel's oracle,
    dequantizes first ((k8 * ks) . q), as the Pallas kernel does.  Same
    masks and shapes as that function; int8 pages with (P, page_size)
    f32 scales."""
    b, hkv, tg, d = q.shape
    group = _group(tg, t_window)
    k8 = gather_pages(k_pages, block_tables).float()
    v8 = gather_pages(v_pages, block_tables).float()
    s_len = k8.shape[1]
    flat = block_tables.reshape(-1).to(device=k_scales.device, dtype=torch.long)
    ks, vs = (x.index_select(0, flat).reshape(b, s_len) for x in (k_scales, v_scales))
    pos = pos.to(device=q.device, dtype=torch.long)
    ki = torch.arange(s_len, device=q.device)
    limit = pos[:, None] + torch.arange(tg, device=q.device)[None, :] // group
    live = (ki[None, None, :] <= limit[:, :, None])[:, None]       # (B, 1, TG, S)
    in_window = ki[None, :] <= (pos + t_window - 1)[:, None]       # (B, S)
    ks, vs = (torch.where(in_window, x, 0.0) for x in (ks, vs))
    s = torch.einsum("bhrd,bkhd->bhrk", q.float(), k8) * ks[:, None, None, :] * (d ** -0.5)
    s = torch.where(live, s, MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    v8 = torch.where(in_window[:, :, None, None], v8, 0.0)
    o = torch.einsum("bhrk,bkhd->bhrd", p * vs[:, None, None, :], v8)
    return (o / torch.where(l == 0.0, 1.0, l)).to(q.dtype)
