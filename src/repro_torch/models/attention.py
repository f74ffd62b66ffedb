"""GQA attention: prefill (flash kernel), dense and paged decode, the
paged k-token speculative verify, and the projections around them.
Counterpart of ``repro.models.attention`` for the dense family, in the
same layouts: activations (B, S, H, D), weights (d_in, d_out) applied as
``x @ W``.

Every attention call goes through a kernel wrapper (CUDA kernel on CUDA
tensors, plain version on CPU tensors); ``use_kernel=False`` calls the
plain versions directly on any device.  Prefill and training attention
is differentiable on both routes: the kernel route through
``FlashAttention`` (forward and backward kernels), the plain route
through autograd.  Weights are cast to the activations' dtype at use, as
the reference's ``x @ w.astype(x.dtype)`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import flash_decode, paged_flash_decode
from repro_torch.kernels.decode_attention.ref import (
    flash_decode_ref,
    paged_flash_decode_ref,
)
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.verify_attention.ops import paged_flash_verify
from repro_torch.kernels.verify_attention.ref import paged_verify_attention_ref
from repro_torch.models.layers import apply_rope, rope_freqs

NEG_INF = -1e30   # the reference's jnp-path mask (attention.py:24)


def _flash_ok(q, k, causal: bool, q_offset: int) -> bool:
    """Can the flash kernel express this call?  q_offset must be zero (the
    kernel's causal mask is anchored at position 0) and causal attention
    must be square; single-token queries stay on the decode/plain paths."""
    sq, skv = q.shape[1], k.shape[1]
    if q_offset != 0 or sq <= 1:
        return False
    return not (causal and sq != skv)


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  kv_valid_len: Optional[torch.Tensor] = None,
                  use_kernel: bool = True) -> torch.Tensor:
    """q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D), Hq % Hkv == 0 -> (B, Sq, Hq, D).

    Shapes the flash kernel can express go through it; the rest (one-token
    queries, offset or non-square causal windows) take a materialized
    softmax, the reference's jnp path."""
    if _flash_ok(q, k, causal, q_offset):
        if use_kernel:
            return flash_mha(q, k, v, kv_valid_len, causal=causal)
        return flash_attention_ref(q, k, v, kv_valid_len, causal=causal)[0]
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d ** -0.5
    ki = torch.arange(skv, device=q.device)
    if causal:
        qi = q_offset + torch.arange(sq, device=q.device)
        s = torch.where(qi[:, None] >= ki[None, :], s, NEG_INF)
    if kv_valid_len is not None:
        valid = ki[None, :] < kv_valid_len[:, None]                   # (B, Skv)
        s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     attend_len: Optional[int] = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """One-token decode: q (B, 1, Hq, D), caches (B, Smax, Hkv, D), pos (B,)
    (cache filled through pos inclusive).  ``attend_len`` bounds the read
    to the live prefix: the slice is a strided view, not a copy."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    if attend_len is not None and attend_len < k_cache.shape[1]:
        k_cache = k_cache[:, :attend_len]
        v_cache = v_cache[:, :attend_len]
    qg = q.reshape(b, hkv, hq // hkv, d)
    fn = flash_decode if use_kernel else flash_decode_ref
    return fn(qg, k_cache, v_cache, pos).reshape(b, 1, hq, d)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           attend_len: Optional[int] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None,
                           use_kernel: bool = True) -> torch.Tensor:
    """One-token decode against the paged pool: q (B, 1, Hq, D), pages
    (P, page_size, Hkv, D), block_tables (B, NB), pos (B,).  Only the first
    ceil(attend_len / page_size) table columns are visited.
    ``k_scales``/``v_scales`` ((P, page_size) float32, both or neither):
    int8 pages, dequantized inside the gather on both lowerings."""
    page_size = k_pages.shape[1]
    if attend_len is not None:
        block_tables = block_tables[:, :-(-attend_len // page_size)]
    b, _, hq, d = q.shape
    hkv = k_pages.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d)
    fn = paged_flash_decode if use_kernel else paged_flash_decode_ref
    return fn(qg, k_pages, v_pages, block_tables, pos, k_scales=k_scales,
              v_scales=v_scales).reshape(b, 1, hq, d)


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           pos: torch.Tensor, *,
                           attend_len: Optional[int] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None,
                           use_kernel: bool = True) -> torch.Tensor:
    """k-token speculative verify against the paged pool: q (B, T, Hq, D)
    holds the window's queries at positions pos..pos+T-1 (whose K/V rows
    are already written through the block tables), pages (P, page_size,
    Hkv, D), block_tables (B, NB), pos (B,) the window's first position.
    Query t attends positions <= pos + t.  Returns (B, T, Hq, D).

    The kernel takes the window's T rows and the G grouped queries on one
    row axis per KV head, (B, Hkv, T*G, D) t-major, so its ``row // G`` is
    the window offset (the reference adapter, ``verify_attention/ops.py``).
    ``attend_len`` bounds pos + T: only the first ceil(attend_len /
    page_size) table columns are visited.  ``k_scales``/``v_scales``: int8
    pages, as in :func:`paged_decode_attention`."""
    page_size = k_pages.shape[1]
    if attend_len is not None:
        block_tables = block_tables[:, :-(-attend_len // page_size)]
    b, t, hq, d = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, d).transpose(1, 2).reshape(b, hkv, t * g, d)
    fn = paged_flash_verify if use_kernel else paged_verify_attention_ref
    o = fn(qg, k_pages, v_pages, block_tables, pos, t_window=t,
           k_scales=k_scales, v_scales=v_scales)
    return o.reshape(b, hkv, t, g, d).transpose(1, 2).reshape(b, t, hq, d)


# ---------------------------------------------------------------------------
# GQA block: projections + rope
# ---------------------------------------------------------------------------

def gqa_qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor,
            rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = q.reshape(b, s, hq, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    cos, sin = rope if rope is not None else rope_freqs(dh, cfg.rope_theta, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_block_kv(params, x: torch.Tensor, cfg, *, use_kernel: bool = True):
    """Causal self-attention block over positions 0..S-1; also returns the
    (k, v) rows for prefill caching."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v = gqa_qkv(params, x, cfg, positions)
    o = gqa_attention(q, k, v, causal=True, use_kernel=use_kernel)
    return o.reshape(b, s, -1) @ params["wo"].to(x.dtype), (k, v)


def gqa_block(params, x: torch.Tensor, cfg, *, use_kernel: bool = True) -> torch.Tensor:
    """The training block: causal self-attention over positions 0..S-1,
    no cache writes."""
    return gqa_block_kv(params, x, cfg, use_kernel=use_kernel)[0]
