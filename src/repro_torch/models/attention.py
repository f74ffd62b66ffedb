"""GQA attention: prefill (flash kernel), dense and paged decode, the
paged k-token speculative verify, and the projections around them; and
MLA (MiniCPM3 / DeepSeek-V2), whose prefill decompresses the latent into
per-head K/V for the flash kernel's Dv != D branch and whose decode
attends in the latent space.  Counterpart of ``repro.models.attention``
for the dense family, in the same layouts: activations (B, S, H, D),
weights (d_in, d_out) applied as ``x @ W``.

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
from repro_torch.models.layers import (
    DEFAULT_WF,
    apply_rope,
    dense_init,
    rmsnorm,
    rope_freqs,
)

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
                  pv_bf16: bool = False,
                  use_kernel: bool = True) -> torch.Tensor:
    """q (B, Sq, Hq, D); k (B, Skv, Hkv, D); v (B, Skv, Hkv, Dv), Hq % Hkv
    == 0 -> (B, Sq, Hq, Dv) (MLA: the value head dim differs from D).

    Shapes the flash kernel can express go through it; the rest (one-token
    queries, offset or non-square causal windows) take a materialized
    softmax, the reference's jnp path.  ``pv_bf16``: the materialized
    path contracts P with V in bf16 (fp32 scores and softmax, P and V
    cast to bf16), as the reference's jnp path does; the kernel ignores
    it, so with ``use_kernel`` False a flash-shaped call takes the
    materialized path instead of ``flash_attention_ref``."""
    if _flash_ok(q, k, causal, q_offset) and (use_kernel or not pv_bf16):
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
    if pv_bf16:
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.bfloat16(), v.bfloat16()).float()
    else:
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, v.shape[-1]).to(q.dtype)


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
    o = gqa_attention(q, k, v, causal=True, pv_bf16=cfg.pv_bf16, use_kernel=use_kernel)
    return o.reshape(b, s, -1) @ params["wo"].to(x.dtype), (k, v)


def gqa_block(params, x: torch.Tensor, cfg, *, use_kernel: bool = True) -> torch.Tensor:
    """The training block: causal self-attention over positions 0..S-1,
    no cache writes."""
    return gqa_block_kv(params, x, cfg, use_kernel=use_kernel)[0]


# ---------------------------------------------------------------------------
# MLA (MiniCPM3 / DeepSeek-V2): latent-compressed KV
# ---------------------------------------------------------------------------

MLA_NORM_EPS = 1e-6   # the reference's rmsnorm default, not cfg.norm_eps


def init_mla_params(gen: torch.Generator, cfg, *, device, dtype) -> dict:
    """One layer's MLA weights, the reference's ``init_mla_params``
    distributions (its draws differ: the tests carry weights over)."""
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kw = dict(device=device, dtype=dtype)
    return {
        "q_down": dense_init(gen, d, qr, **kw),
        "q_norm": torch.ones(qr, **kw),
        "q_up": dense_init(gen, qr, h * (nd + rd), **kw),
        "kv_down": dense_init(gen, d, kr + rd, **kw),
        "kv_norm": torch.ones(kr, **kw),
        "kv_up": dense_init(gen, kr, h * (nd + vd), **kw),
        "wo": dense_init(gen, h * vd, d, **kw),
    }


def _mla_qkv(params, x: torch.Tensor, cfg, positions: torch.Tensor,
             use_kernel: bool = True):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope), latent (B, S, kr),
    k_rope (B, S, rope)) at ``positions``.  The two latent norms are the
    reference's ``rmsnorm(x, w)``: eps 1e-6 and the default reduction
    form whatever the model's ``wf``; ``use_kernel`` False takes their
    plain version.  RoPE spans the rope dims alone, and k_rope is one head
    shared by all."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nd, rd, kr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    dt = x.dtype
    cq = rmsnorm(x @ params["q_down"].to(dt), params["q_norm"], MLA_NORM_EPS,
                 use_kernel, DEFAULT_WF)
    q = (cq @ params["q_up"].to(dt)).reshape(b, s, h, nd + rd)
    q_nope, q_rope = q[..., :nd], q[..., nd:]
    ckv = x @ params["kv_down"].to(dt)
    latent = rmsnorm(ckv[..., :kr], params["kv_norm"], MLA_NORM_EPS, use_kernel,
                     DEFAULT_WF)
    cos, sin = rope_freqs(rd, cfg.rope_theta, positions)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(ckv[:, :, None, kr:], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, latent, k_rope


def mla_block_kv(params, x: torch.Tensor, cfg, *, use_kernel: bool = True,
                 norm_kernel: bool = True):
    """Causal MLA self-attention over positions 0..S-1, the latent
    decompressed into per-head K/V (the naive form); also returns
    (latent (B, S, kr), k_rope (B, S, rope)) for the prefill's cache.
    q and k are (B, S, H, nope + rope), v (B, S, H, v_head_dim): the flash
    kernel's Dv != D branch.  v is a strided view of the decompressed row
    (nope + v dims a head), not a copy: at MiniCPM3's widths its base is
    128 B into the row and its H stride 128 elements, which the bf16
    kernel's 16-byte alignment check takes.  ``use_kernel`` picks the
    attention lowering, ``norm_kernel`` the latent norms'."""
    b, s, _ = x.shape
    h = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv(params, x, cfg, positions, norm_kernel)
    kv = (latent @ params["kv_up"].to(x.dtype)).reshape(b, s, h, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)], dim=-1)
    o = gqa_attention(q, k, v, causal=True, pv_bf16=cfg.pv_bf16, use_kernel=use_kernel)
    return o.reshape(b, s, -1) @ params["wo"].to(x.dtype), (latent, k_rope)


def mla_block(params, x: torch.Tensor, cfg, *, use_kernel: bool = True,
              norm_kernel: bool = True) -> torch.Tensor:
    """The training block: :func:`mla_block_kv` without the cache rows."""
    return mla_block_kv(params, x, cfg, use_kernel=use_kernel,
                        norm_kernel=norm_kernel)[0]


def mla_decode_block(params, x: torch.Tensor, cfg, lat_cache: torch.Tensor,
                     rope_cache: torch.Tensor, pos: torch.Tensor, *,
                     attend_len: Optional[int] = None,
                     use_kernel: bool = True) -> torch.Tensor:
    """Absorbed-matmul decode of one token a row, x (B, 1, d): attention
    runs in the latent space, so the layer's cache holds only latent
    (B, Smax, kr) and rope (B, Smax, rope) rows, written at ``pos`` in
    place (a row past the cache clamps onto its last row, as the
    reference's ``dynamic_update_slice``).  The read is sliced to
    ``attend_len`` first, then masked to positions <= pos; scores, softmax
    and the latent context are fp32, the output cast back to x.dtype.  No
    kernel: the reference's decode is fp32 einsums too.  ``use_kernel``
    picks the latent norms' lowering.  Returns (B, 1, d)."""
    b = x.shape[0]
    h = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    q_nope, q_rope, latent, k_rope = _mla_qkv(params, x, cfg, pos[:, None], use_kernel)
    bidx = torch.arange(b, device=x.device)
    row = torch.clamp(pos.long(), max=lat_cache.shape[1] - 1)
    lat_cache[bidx, row] = latent[:, 0].to(lat_cache.dtype)
    rope_cache[bidx, row] = k_rope[:, 0].to(rope_cache.dtype)
    lat_read, rope_read = lat_cache, rope_cache
    if attend_len is not None and attend_len < lat_cache.shape[1]:
        lat_read, rope_read = lat_cache[:, :attend_len], rope_cache[:, :attend_len]
    kv_up = params["kv_up"].reshape(kr, h, nd + vd)
    w_uk, w_uv = kv_up[..., :nd], kv_up[..., nd:]
    # absorb W_uk into the query: q' = q_nope @ W_uk^T, in latent space
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope, w_uk.to(x.dtype))
    lat_f = lat_read.float()
    s = (torch.einsum("bhr,bkr->bhk", q_lat[:, 0].float(), lat_f)
         + torch.einsum("bhr,bkr->bhk", q_rope[:, 0].float(), rope_read.float()))
    s = s * (nd + rd) ** -0.5
    ki = torch.arange(lat_read.shape[1], device=x.device)
    s = torch.where((ki[None, :] <= pos[:, None])[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhk,bkr->bhr", p, lat_f)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv.float()).to(x.dtype)
    return (o.reshape(b, -1) @ params["wo"].to(x.dtype))[:, None, :]
