"""Dense-family language model: init, prefill, decode step, KV caches.

Counterpart of ``repro.models.lm.Model`` for the dense GQA family, with
the same functional interface and parameter pytree (a nested dict whose
``layers`` leaves are stacked (L, ...)), so ``repro_torch.testing`` can
carry the reference's weights over leaf for leaf:

  init(gen)                                  -> params
  init_cache(B, max_seq, layout=...)         -> dense or paged cache
  prefill(params, tokens, max_seq, last_pos) -> (last logits (B, V), dense cache)
  decode_step(params, cache, tok, pos, attend_len) -> (logits (B, V), cache)

Where the reference jits with donated buffers, the port writes cache rows
in place (``ck[l, bidx, pos] = k``): ``decode_step`` returns the very
cache dict it was given, updated.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (
    decode_attention,
    gqa_block_kv,
    gqa_qkv,
    paged_decode_attention,
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
from repro_torch.serve.kv_cache import TRASH_PAGE, cdiv, init_page_pool

Params = Dict[str, Any]


def _layer(tree, l: int):
    """Layer ``l``'s slice of the stacked (L, ...) layer leaves (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


class Model:
    """Dense GQA decoder (qwen2-style: q/k/v biases, untied ``lm_head``).

    ``device`` defaults to ``cuda`` and raises without it; ``dtype`` is the
    compute and storage dtype of weights, activations and caches.
    ``use_kernels=False`` routes every kernel site to its plain PyTorch
    version on any device (the reference path a chip run checks the
    kernels against); by default kernel wrappers are called, which run
    their plain version only for CPU tensors.  ``wf`` picks the norm
    reductions' HW/SW form (``layers.WarpFeatureConfig``), as the
    reference's ``Model(wf=...)`` does."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16, use_kernels: bool = True,
                 wf: WarpFeatureConfig = DEFAULT_WF):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP A14)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.wf = wf

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> Params:
        """Random weights with the reference's distributions, drawn from
        ``gen`` (which must live on ``self.device``)."""
        cfg, dev, dt = self.cfg, self.device, self.dtype
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
        return {
            "embed": embed_init(gen, cfg.vocab, d, **kw),
            "ln_f": torch.ones(d, **kw),
            "lm_head": dense_init(gen, d, cfg.vocab, **kw),
            "layers": {
                "ln1": torch.ones(L, d, **kw),
                "ln2": torch.ones(L, d, **kw),
                "attn": attn,
                "mlp": {"w_gate": stacked(d, f), "w_up": stacked(d, f),
                        "w_down": stacked(f, d)},
            },
        }

    # ----------------------------------------------------------------- cache
    def init_cache(self, batch_size: int, max_seq: int, *, layout: str = "dense",
                   page_size: int = 16, num_pages: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
        """'dense': {"k"/"v": (L, B, max_seq, Hkv, D)}.  'paged': a shared
        pool {"k_pages"/"v_pages": (L, num_pages, page_size, Hkv, D)} plus
        (B, ceil(max_seq / page_size)) block tables at the trash page."""
        cfg = self.cfg
        L, b = cfg.n_layers, batch_size
        if layout == "paged":
            if num_pages is None:
                num_pages = b * cdiv(max_seq, page_size) + 1
            cache = init_page_pool(L, num_pages, page_size, cfg.n_kv_heads,
                                   cfg.d_head, self.dtype, self.device)
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
        return (x @ params["lm_head"]).float()

    def _mlp_residual(self, p, x: torch.Tensor) -> torch.Tensor:
        g = self._norm(x, p["ln2"])
        m = p["mlp"]
        return x + swiglu(g, m["w_gate"], m["w_up"], m["w_down"])

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, max_seq: int,
                last_pos: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (logits (B, V) at each row's last real token,
        dense cache {"k"/"v": (L, B, max(max_seq, S), Hkv, D)} with
        positions [0, S) filled and the rest zero).

        last_pos (B,): index of each row's last real token in a
        right-padded batch; the causal mask keeps it independent of the
        padding, so its logits are exact."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        b, s = tokens.shape
        x = self._embed(params, tokens)
        shape = (cfg.n_layers, b, max(max_seq, s), cfg.n_kv_heads, cfg.d_head)
        ck = torch.zeros(shape, dtype=self.dtype, device=self.device)
        cv = torch.zeros(shape, dtype=self.dtype, device=self.device)
        for l in range(cfg.n_layers):
            p = _layer(params["layers"], l)
            g = self._norm(x, p["ln1"])
            att, (k, v) = gqa_block_kv(p["attn"], g, cfg, use_kernel=self.use_kernels)
            x = x + att
            ck[l, :, :s] = k
            cv[l, :, :s] = v
            x = self._mlp_residual(p, x)
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
        """Shared decode layer loop; ``write_attend(l, q, k, v)`` owns the
        layout-specific cache write and read, so the dense and paged steps
        share every other line."""
        cfg = self.cfg
        b, s, _ = x.shape
        rope = rope_freqs(cfg.d_head, cfg.rope_theta, positions)
        for l in range(cfg.n_layers):
            p = _layer(params["layers"], l)
            g = self._norm(x, p["ln1"])
            q, k, v = gqa_qkv(p["attn"], g, cfg, positions, rope=rope)
            o = write_attend(l, q, k, v)
            x = x + o.reshape(b, s, -1) @ p["attn"]["wo"]
            x = self._mlp_residual(p, x)
        return self._head(params, x)[:, 0, :cfg.vocab]

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

        return self._gqa_decode_layers(params, x, pos[:, None], write_attend), cache

    def _gqa_decode_paged(self, params, cache, x, pos, attend_len):
        """The fresh K/V row lands at (page, offset) resolved through the
        slot's block table; dead slots' tables point at the trash page,
        so their writes are harmless."""
        if "k_scales" in cache:
            raise NotImplementedError("int8 pages are not ported yet (ROADMAP A9)")
        kp, vp, bt = cache["k_pages"], cache["v_pages"], cache["block_tables"]
        page_size = kp.shape[2]
        bidx = torch.arange(x.shape[0], device=self.device)
        blk = torch.clamp(pos.long() // page_size, max=bt.shape[1] - 1)
        page = bt[bidx, blk].long()
        off = pos.long() % page_size

        def write_attend(l, q, k, v):
            kp[l, page, off] = k[:, 0]
            vp[l, page, off] = v[:, 0]
            return paged_decode_attention(q, kp[l], vp[l], bt, pos,
                                          attend_len=attend_len,
                                          use_kernel=self.use_kernels)

        return self._gqa_decode_layers(params, x, pos[:, None], write_attend), cache
