"""Dense- and MoE-family language model: init, prefill, decode step, KV
caches.

Counterpart of ``repro.models.lm.Model`` for the dense and the MoE GQA
families, with the same functional interface and parameter pytree (a
nested dict whose ``layers`` leaves are stacked (L, ...); the MoE family
has ``layers.moe`` in place of ``layers.mlp``), so ``repro_torch.testing``
can carry the reference's weights over leaf for leaf:

  init(gen)                                  -> params
  backbone(params, batch)                    -> hidden (B, S, d)  [train]
  forward(params, batch)                     -> logits (B, S, V)  [train]
  init_cache(B, max_seq, layout=..., kv_dtype=...) -> dense or paged cache
  prefill(params, tokens, max_seq, last_pos) -> (last logits (B, V), dense cache)
  decode_step(params, cache, tok, pos, attend_len) -> (logits (B, V), cache)
  decode_verify_step(params, paged cache, window (B, T), pos, attend_len)
                                             -> (logits (B, T, V), cache)

Where the reference jits with donated buffers, the port writes cache rows
in place (``ck[l, bidx, pos] = k``): ``decode_step`` returns the very
cache dict it was given, updated.  ``backbone`` and ``forward`` run with
autograd (remat per layer, as the reference's ``jax.checkpoint`` of the
scanned block); the serving entry points run without it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (
    decode_attention,
    gqa_block,
    gqa_block_kv,
    gqa_qkv,
    paged_decode_attention,
    paged_verify_attention,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    DEFAULT_WF,
    WarpFeatureConfig,
    dense_init,
    embed_init,
    rmsnorm,
    rope_freqs,
    swiglu,
)
from repro_torch.models.moe import init_moe_params, moe_block
from repro_torch.serve.kv_cache import (
    TRASH_PAGE,
    cdiv,
    init_page_pool,
    quantize_kv_rows,
)

Params = Dict[str, Any]
# one attention site's lowering (Model's attn_backend, verify_backend):
# 'kernel' the CUDA kernel (its plain version on CPU tensors), 'torch' the
# plain version on any device, None whatever Model.use_kernels says
BACKENDS = (None, "kernel", "torch")


def _unstack(tree) -> list:
    """The per-layer slices (views) of the stacked (L, ...) layer leaves,
    by one ``unbind`` per leaf: in training its backward stacks the L
    layer gradients once, where L indexing views would each add a
    full-size zero gradient."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[l] for k, v in per_key.items()} for l in range(n)]
    return list(torch.unbind(tree, 0))


def _write_rows(cache, l: int, page: torch.Tensor, off: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write fresh K/V rows (..., Hkv, D) of layer ``l`` at (page, offset)
    pairs of the paged pool, in place; a quantized pool stores each row
    quantized and its scale.  Returns the layer's scale operands for the
    attention read ({} for a float pool)."""
    kp, vp = cache["k_pages"], cache["v_pages"]
    if "k_scales" not in cache:
        kp[l, page, off] = k
        vp[l, page, off] = v
        return {}
    ks, vs = cache["k_scales"], cache["v_scales"]
    kp[l, page, off], ks[l, page, off] = quantize_kv_rows(k)
    vp[l, page, off], vs[l, page, off] = quantize_kv_rows(v)
    return {"k_scales": ks[l], "v_scales": vs[l]}


class Model:
    """GQA decoder (q/k/v biases where the config has them, untied
    ``lm_head``) with a SwiGLU MLP (``family == "dense"``) or a top-k MoE
    (``"moe"``: gating through the ``moe_gating`` kernel, the experts as
    the reference's one-hot dispatch) in each layer.

    ``device`` defaults to ``cuda`` and raises without it; ``dtype`` is the
    compute dtype of activations and the storage dtype of caches;
    ``param_dtype`` (None: ``dtype``) that of the weights, which every
    site casts to ``dtype`` at use, as the reference's ``param_dtype`` /
    ``compute_dtype`` pair (training: fp32 weights, bf16 compute).
    ``use_kernels=False`` routes every kernel site to its plain PyTorch
    version on any device (the reference path a chip run checks the
    kernels against); by default kernel wrappers are called, which run
    their plain version only for CPU tensors.  ``attn_backend`` (one of
    ``BACKENDS``) picks prefill and training attention alone, as the
    reference's ``attn_backend``.  ``wf`` picks the
    norm reductions' HW/SW form (``layers.WarpFeatureConfig``), as the
    reference's ``Model(wf=...)`` does.  ``remat`` recomputes each layer
    in the backward pass (``torch.utils.checkpoint``), keeping only the
    layer inputs alive."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None,
                 use_kernels: bool = True, attn_backend: Optional[str] = None,
                 wf: WarpFeatureConfig = DEFAULT_WF, remat: bool = True):
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP A14)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.param_dtype = dtype if param_dtype is None else param_dtype
        self.use_kernels = use_kernels
        self.attn_kernel = self.uses_kernel(attn_backend, "attn_backend")
        self.wf = wf
        self.remat = remat

    def uses_kernel(self, backend: Optional[str], what: str) -> bool:
        """Whether an attention site lowered by ``backend`` (one of
        ``BACKENDS``; ``what`` names it in the error) calls the kernel."""
        if backend not in BACKENDS:
            raise ValueError(f"{what} must be one of {BACKENDS}; got {backend!r}")
        return self.use_kernels if backend is None else backend == "kernel"

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> Params:
        """Random weights in ``param_dtype`` with the reference's
        distributions, drawn from ``gen`` (which must live on
        ``self.device``)."""
        cfg, dev, dt = self.cfg, self.device, self.param_dtype
        d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        kw = dict(device=dev, dtype=dt)

        def stacked(d_in, d_out):
            return torch.stack([dense_init(gen, d_in, d_out, **kw)
                                for _ in range(L)])

        attn = {"wq": stacked(d, hq * dh), "wk": stacked(d, hkv * dh),
                "wv": stacked(d, hkv * dh), "wo": stacked(hq * dh, d)}
        if cfg.qkv_bias:
            attn.update(bq=torch.zeros(L, hq * dh, **kw),
                        bk=torch.zeros(L, hkv * dh, **kw),
                        bv=torch.zeros(L, hkv * dh, **kw))
        if cfg.family == "moe":
            per_layer = [init_moe_params(gen, cfg, **kw) for _ in range(L)]
            ffn = {"moe": {k: torch.stack([p[k] for p in per_layer])
                           for k in per_layer[0]}}
        else:
            ffn = {"mlp": {"w_gate": stacked(d, f), "w_up": stacked(d, f),
                           "w_down": stacked(f, d)}}
        return {
            "embed": embed_init(gen, cfg.vocab, d, **kw),
            "ln_f": torch.ones(d, **kw),
            "lm_head": dense_init(gen, d, cfg.vocab, **kw),
            "layers": {
                "ln1": torch.ones(L, d, **kw),
                "ln2": torch.ones(L, d, **kw),
                "attn": attn,
                **ffn,
            },
        }

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_seq: int, *, layout: str = "dense",
                   page_size: int = 16, num_pages: Optional[int] = None,
                   kv_dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """'dense': {"k"/"v": (L, B, max_seq, Hkv, D)}.  'paged': a shared
        pool {"k_pages"/"v_pages": (L, num_pages, page_size, Hkv, D)} plus
        (B, ceil(max_seq / page_size)) block tables at the trash page.

        kv_dtype (paged only): 'bf16' | 'int8' | None.  'int8' stores the
        pool quantized with per-row scale leaves ``k_scales``/``v_scales``
        (``repro_torch.serve.kv_cache``)."""
        cfg = self.cfg
        L, b = cfg.n_layers, batch_size
        if kv_dtype is not None and layout != "paged":
            raise ValueError("kv_dtype is a paged-layout axis; "
                             f"got layout={layout!r}")
        if layout == "paged":
            if num_pages is None:
                num_pages = b * cdiv(max_seq, page_size) + 1
            cache = init_page_pool(L, num_pages, page_size, cfg.n_kv_heads,
                                   cfg.d_head, self.dtype, self.device,
                                   kv_dtype=kv_dtype)
            cache["block_tables"] = torch.full(
                (b, cdiv(max_seq, page_size)), TRASH_PAGE, dtype=torch.int32,
                device=self.device)
            return cache
        if layout != "dense":
            raise ValueError(f"unknown cache layout {layout!r}")
        shape = (L, b, max_seq, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    # --------------------------------------------------------------- pieces
    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, w, self.cfg.norm_eps, self.use_kernels, self.wf)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(self.dtype)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        x = self._norm(x, params["ln_f"])
        return (x @ params["lm_head"].to(x.dtype)).float()

    def _mlp_residual(self, p, x: torch.Tensor,
                      capacity_factor: float) -> torch.Tensor:
        """x + the layer's MLP of its pre-norm; an MoE layer dispatches
        with the capacity factor of its call site, as the reference's:
        training ``cfg.capacity_factor``, prefill
        ``cfg.infer_capacity_factor``, decode and verify at least 8."""
        g = self._norm(x, p["ln2"])
        if self.cfg.family == "moe":
            return x + moe_block(p["moe"], g, self.cfg,
                                 capacity_factor=capacity_factor,
                                 use_kernel=self.use_kernels)
        m = p["mlp"]
        return x + swiglu(g, m["w_gate"], m["w_up"], m["w_down"])

    def _tf_block(self, p, x: torch.Tensor) -> torch.Tensor:
        """One training layer: causal attention over the whole sequence
        and the MLP, both pre-norm residual (the reference's
        ``_tf_block``)."""
        g = self._norm(x, p["ln1"])
        x = x + gqa_block(p["attn"], g, self.cfg, use_kernel=self.attn_kernel)
        return self._mlp_residual(p, x, self.cfg.capacity_factor)

    # -------------------------------------------------------------- forward
    def backbone(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Hidden states (B, S, d) for batch["tokens"] (B, S), no final
        norm and no head, with autograd: the train step feeds them to a
        vocab-chunked loss.  With ``remat`` each layer is recomputed in
        the backward pass (its attention kernel included)."""
        x = self._embed(params, batch["tokens"].to(self.device))
        for p in _unstack(params["layers"]):
            if self.remat:
                # no randomness inside a layer: nothing to replay
                x = checkpoint(self._tf_block, p, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._tf_block(p, x)
        return x

    def forward(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V) in float32 for batch["tokens"] (B, S)."""
        return self._head(params, self.backbone(params, batch))[..., :self.cfg.vocab]

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, max_seq: int,
                last_pos: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (logits (B, V) at each row's last real token,
        dense cache {"k"/"v": (L, B, max(max_seq, S), Hkv, D)} with
        positions [0, S) filled and the rest zero).

        last_pos (B,): index of each row's last real token in a
        right-padded batch; the causal mask keeps it independent of the
        padding, so its logits are exact.  Not so for the MoE family,
        whose expert capacity depends on the row's length: its rows are
        prefilled alone at their exact length (``ServeEngine``)."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        b, s = tokens.shape
        x = self._embed(params, tokens)
        shape = (cfg.n_layers, b, max(max_seq, s), cfg.n_kv_heads, cfg.d_head)
        ck = torch.zeros(shape, dtype=self.dtype, device=self.device)
        cv = torch.zeros(shape, dtype=self.dtype, device=self.device)
        for l, p in enumerate(_unstack(params["layers"])):
            g = self._norm(x, p["ln1"])
            att, (k, v) = gqa_block_kv(p["attn"], g, cfg, use_kernel=self.attn_kernel)
            x = x + att
            ck[l, :, :s] = k
            cv[l, :, :s] = v
            x = self._mlp_residual(p, x, cfg.infer_capacity_factor)
        if last_pos is None:
            last = x[:, -1:]
        else:
            last = x[torch.arange(b, device=self.device),
                     last_pos.to(self.device).long()][:, None]
        return self._head(params, last)[:, 0, :cfg.vocab], {"k": ck, "v": cv}

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, params, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: torch.Tensor,
                    attend_len: Optional[int] = None):
        """tokens (B,) int; pos (B,) positions.  Returns (logits (B, V),
        cache) with each row's K/V written at ``pos`` in place.

        attend_len: bound on the valid cache prefix (max(pos) < attend_len)
        so attention reads only the live part of the cache.  A paged cache
        (``k_pages`` leaf) writes through its block tables instead."""
        x = self._embed(params, tokens[:, None])
        if "k_pages" in cache:
            return self._gqa_decode_paged(params, cache, x, pos, attend_len)
        return self._gqa_decode_unrolled(params, cache, x, pos, attend_len)

    def _gqa_decode_layers(self, params, x, positions,
                           write_attend: Callable) -> torch.Tensor:
        """Shared decode/verify layer loop over x (B, S, d) at absolute
        ``positions`` (B, S): S = 1 is one-token decode, S = T a
        speculative window.  ``write_attend(l, q, k, v)`` owns the
        layout-specific cache write and read, so the dense, paged and
        verify steps share every other line.  Returns the hidden
        (B, S, d); each caller applies the head."""
        cfg = self.cfg
        b, s, _ = x.shape
        rope = rope_freqs(cfg.d_head, cfg.rope_theta, positions)
        for l, p in enumerate(_unstack(params["layers"])):
            g = self._norm(x, p["ln1"])
            q, k, v = gqa_qkv(p["attn"], g, cfg, positions, rope=rope)
            o = write_attend(l, q, k, v)
            x = x + o.reshape(b, s, -1) @ p["attn"]["wo"].to(x.dtype)
            x = self._mlp_residual(p, x, max(cfg.infer_capacity_factor, 8.0))
        return x

    def _decode_logits(self, params, x, pos, write_attend):
        x = self._gqa_decode_layers(params, x, pos[:, None], write_attend)
        return self._head(params, x)[:, 0, :self.cfg.vocab]

    def _gqa_decode_unrolled(self, params, cache, x, pos, attend_len):
        ck, cv = cache["k"], cache["v"]
        bidx = torch.arange(x.shape[0], device=self.device)
        # a finished slot coasting in the batch may run past the cache: its
        # write clamps onto the last row, which no live row reads
        row = torch.clamp(pos.long(), max=ck.shape[2] - 1)

        def write_attend(l, q, k, v):
            ck[l, bidx, row] = k[:, 0]
            cv[l, bidx, row] = v[:, 0]
            return decode_attention(q, ck[l], cv[l], pos, attend_len=attend_len,
                                    use_kernel=self.use_kernels)

        return self._decode_logits(params, x, pos, write_attend), cache

    def _gqa_decode_paged(self, params, cache, x, pos, attend_len):
        """The fresh K/V row lands at (page, offset) resolved through the
        slot's block table; dead slots' tables point at the trash page,
        so their writes are harmless.  A quantized pool (scale leaves)
        stores the row quantized with its scale, and attention dequantizes
        in its gather."""
        bt = cache["block_tables"]
        page_size = cache["k_pages"].shape[2]
        bidx = torch.arange(x.shape[0], device=self.device)
        blk = torch.clamp(pos.long() // page_size, max=bt.shape[1] - 1)
        page = bt[bidx, blk].long()
        off = pos.long() % page_size

        def write_attend(l, q, k, v):
            scales = _write_rows(cache, l, page, off, k[:, 0], v[:, 0])
            return paged_decode_attention(q, cache["k_pages"][l], cache["v_pages"][l],
                                          bt, pos, attend_len=attend_len, **scales,
                                          use_kernel=self.use_kernels)

        return self._decode_logits(params, x, pos, write_attend), cache

    # ---------------------------------------------------- speculative verify
    @torch.no_grad()
    def decode_verify_step(self, params, cache: Dict[str, torch.Tensor],
                           tokens: torch.Tensor, pos: torch.Tensor,
                           attend_len: Optional[int] = None,
                           verify_backend: Optional[str] = None):
        """Score a T-token speculative window in one pass (paged cache).

        tokens (B, T): row b holds [last committed token, draft_1, ...,
        draft_{T-1}] at positions pos[b]..pos[b]+T-1.  Returns (logits
        (B, T, V), cache): logits[:, i] is the target's distribution for
        position pos+i+1 given the committed prefix and window tokens
        0..i, what T sequential ``decode_step`` calls would give, so
        greedy longest-prefix acceptance equals non-speculative decode.
        Every window row's K/V is written through the block tables before
        the attention read; rejected rows are overwritten by later
        windows.  ``verify_backend``: one of ``BACKENDS``."""
        if "k_pages" not in cache:
            raise ValueError("decode_verify_step needs a paged cache "
                             "(k_pages/v_pages/block_tables); got leaves "
                             f"{sorted(cache)}")
        x = self._embed(params, tokens)
        x, cache = self._paged_window(params, cache, x, pos, attend_len,
                                      verify_backend)
        return self._head(params, x)[..., :self.cfg.vocab], cache

    def _paged_window(self, params, cache, x, pos, attend_len: Optional[int],
                      verify_backend: Optional[str]):
        """The T-token window body over the paged cache: per layer the T
        fresh K/V rows land at table-resolved (page, offset) pairs, then
        verify attention masks each query row at its own position.
        Returns (hidden (B, T, d), cache).  A quantized pool stores each row
        quantized, as :meth:`_gqa_decode_paged`.  (The reference also
        prefills a shared prefix's suffix through it; that arrives with
        ROADMAP A9b.)"""
        use_kernel = self.uses_kernel(verify_backend, "verify_backend")
        bt = cache["block_tables"]
        page_size = cache["k_pages"].shape[2]
        t = x.shape[1]
        positions = pos.long()[:, None] + torch.arange(t, device=self.device)
        blk = positions // page_size
        page = torch.gather(bt, 1, torch.clamp(blk, max=bt.shape[1] - 1)).long()
        # a window straddling the end of the table (pos near max_seq, or a
        # finished slot coasting) must not fold its overflow rows onto the
        # last block: they go to the trash page, and the commit clamp never
        # accepts tokens there
        page = torch.where(blk < bt.shape[1], page, TRASH_PAGE)
        off = positions % page_size

        def write_attend(l, q, k, v):
            scales = _write_rows(cache, l, page, off, k, v)
            return paged_verify_attention(q, cache["k_pages"][l], cache["v_pages"][l],
                                          bt, pos, attend_len=attend_len, **scales,
                                          use_kernel=use_kernel)

        return self._gqa_decode_layers(params, x, positions, write_attend), cache
