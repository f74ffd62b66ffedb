"""Language model of the dense, MoE, RWKV6 and Mamba2-hybrid families:
init, prefill, decode step, caches.

Counterpart of ``repro.models.lm.Model`` for the dense and the MoE GQA
families, the dense family's MLA attention (MiniCPM3), the ``ssm``
family (RWKV6) and the ``hybrid`` family (Zamba2: Mamba2 layers with one
shared attention block), with the same functional interface and
parameter pytree (a nested dict whose ``layers`` leaves are stacked (L,
...); the MoE family has ``layers.moe`` in place of ``layers.mlp``, MLA
its latent projections in ``layers.attn``, RWKV6 ``layers.tm`` between
``ln1`` and ``ln2``, the hybrid ``layers.mamba`` after ``layers.ln`` and
a ``shared_attn`` block beside the layers), so ``repro_torch.testing``
can carry the reference's weights over leaf for leaf:

  init(gen)                                  -> params
  backbone(params, batch)                    -> hidden (B, S, d)  [train]
  forward(params, batch)                     -> logits (B, S, V)  [train]
  init_cache(B, max_seq, layout=..., kv_dtype=...) -> dense or paged cache
                                             (MLA, ssm, hybrid: dense only)
  prefill(params, tokens, max_seq, last_pos) -> (last logits (B, V), dense cache)
  decode_step(params, cache, tok, pos, attend_len) -> (logits (B, V), cache)
  decode_verify_step(params, paged cache, window (B, T), pos, attend_len)
                                             -> (logits (B, T, V), cache)
  prefill_suffix(params, paged cache, suffix (B, T), start_pos, last_idx,
                 attend_len)                 -> (logits (B, V), cache)

Where the reference jits with donated buffers, the port writes cache rows
in place (``ck[l, bidx, pos] = k``, and the recurrent families' new
states over the old ones): ``decode_step`` returns the very cache dict
it was given, updated, so a captured CUDA graph replays it.  ``backbone`` and ``forward`` run with
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
    init_mla_params,
    mla_block,
    mla_block_kv,
    mla_decode_block,
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
from repro_torch.models.recurrent import (
    init_mamba2_params,
    init_rwkv6_params,
    mamba2_mix,
    rwkv6_channel_mix,
    rwkv6_time_mix,
)
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
ATTN_TYPES = ("gqa", "mla")
FAMILIES = ("dense", "moe", "ssm", "hybrid")
# the recurrent families' cache leaves that hold state, not positions
SSM_STATE = ("shift_tm", "wkv", "shift_cm")
HYBRID_STATE = ("conv", "ssm")


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
    """GQA decoder (q/k/v biases where the config has them, an
    ``lm_head`` or, with ``cfg.tie_embeddings``, ``embed.T`` as the head)
    with a SwiGLU MLP (``family == "dense"``) or a top-k MoE
    (``"moe"``: gating through the ``moe_gating`` kernel, the experts as
    the reference's one-hot dispatch) in each layer.  A dense config with
    ``attn_type == "mla"`` has MLA attention instead: prefill and training
    through the flash kernel's Dv != D branch, decode in the latent space
    over a dense latent cache (``supports_paged`` is False).

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
    reference's ``Model(wf=...)`` does.

    ``family == "ssm"`` is RWKV6: each layer a time mix and a channel mix
    (``models.recurrent``) over a cache of states, no attention.
    ``"hybrid"`` is Zamba2: n_layers / k groups of one shared attention
    block (GQA and a SwiGLU MLP, the same weights in every group, a dense
    K/V cache a group) then k Mamba2 layers (k =
    ``cfg.hybrid_attn_every``).  Both prefill one request at a time at
    its exact length in the engine and have no paged layout.
    ``remat`` recomputes each layer
    in the backward pass (``torch.utils.checkpoint``), keeping only the
    layer inputs alive."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None,
                 use_kernels: bool = True, attn_backend: Optional[str] = None,
                 wf: WarpFeatureConfig = DEFAULT_WF, remat: bool = True):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP A14d)")
        if cfg.family == "ssm":
            if cfg.attn_type != "none":
                raise ValueError(f"the ssm family has no attention; got "
                                 f"attn_type {cfg.attn_type!r}")
        elif cfg.attn_type not in ATTN_TYPES:
            raise ValueError(f"attn_type must be one of {ATTN_TYPES}; "
                             f"got {cfg.attn_type!r}")
        if cfg.attn_type == "mla" and cfg.family != "dense":
            # the reference's MLA decode layer is dense (lm.py:533-545)
            raise ValueError(f"MLA attention runs in the dense family; got "
                             f"{cfg.family!r}")
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
        ``self.device``).  ``embed`` has ``cfg.vocab_padded`` rows and
        ``lm_head`` as many columns; a tied model has no ``lm_head``.

        Each stacked (L, ...) leaf is allocated once and filled layer by
        layer, so no leaf exists twice at once (at Qwen1.5-32B a stacked
        copy of ``w_gate`` alone is 17.9 GB in bf16); the draws are those
        of building the L layers and stacking them, in the same order.
        The hybrid's ``shared_attn`` block is drawn once, after the
        layers."""
        cfg, dev, dt = self.cfg, self.device, self.param_dtype
        d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        kw = dict(device=dev, dtype=dt)

        def stacked(d_in, d_out):
            out = torch.empty((L, d_in, d_out), **kw)
            for l in range(L):
                out[l] = dense_init(gen, d_in, d_out, **kw)
            return out

        def stacked_layers(init_layer):
            """L layers of ``init_layer(gen, cfg, **kw)``'s dict, drawn in
            layer order, each leaf stacked (L, ...) as it is drawn"""
            out = None
            for l in range(L):
                layer = init_layer(gen, cfg, **kw)
                if out is None:
                    out = {k: torch.empty((L, *v.shape), **kw) for k, v in layer.items()}
                for k, v in layer.items():
                    out[k][l] = v
                del layer
            return out

        def head(layers):
            params = {"embed": embed_init(gen, cfg.vocab_padded, d, **kw),
                      "ln_f": torch.ones(d, **kw)}
            if not cfg.tie_embeddings:
                params["lm_head"] = dense_init(gen, d, cfg.vocab_padded, **kw)
            params["layers"] = layers
            return params

        if cfg.family == "ssm":   # RWKV6: time and channel mix under "tm"
            return head({"ln1": torch.ones(L, d, **kw),
                         "tm": stacked_layers(init_rwkv6_params),
                         "ln2": torch.ones(L, d, **kw)})
        if cfg.family == "hybrid":   # Zamba2: Mamba2 layers, one shared block
            params = head({"ln": torch.ones(L, d, **kw),
                           "mamba": stacked_layers(init_mamba2_params)})
            params["shared_attn"] = {
                "ln1": torch.ones(d, **kw),
                "attn": {"wq": dense_init(gen, d, hq * dh, **kw),
                         "wk": dense_init(gen, d, hkv * dh, **kw),
                         "wv": dense_init(gen, d, hkv * dh, **kw),
                         "wo": dense_init(gen, hq * dh, d, **kw)},
                "ln2": torch.ones(d, **kw),
                "mlp": {"w_gate": dense_init(gen, d, f, **kw),
                        "w_up": dense_init(gen, d, f, **kw),
                        "w_down": dense_init(gen, f, d, **kw)}}
            return params
        if cfg.attn_type == "mla":
            attn = stacked_layers(init_mla_params)
        else:
            attn = {"wq": stacked(d, hq * dh), "wk": stacked(d, hkv * dh),
                    "wv": stacked(d, hkv * dh), "wo": stacked(hq * dh, d)}
        if cfg.qkv_bias and cfg.attn_type != "mla":
            attn.update(bq=torch.zeros(L, hq * dh, **kw),
                        bk=torch.zeros(L, hkv * dh, **kw),
                        bv=torch.zeros(L, hkv * dh, **kw))
        if cfg.family == "moe":
            ffn = {"moe": stacked_layers(init_moe_params)}
        else:
            ffn = {"mlp": {"w_gate": stacked(d, f), "w_up": stacked(d, f),
                           "w_down": stacked(f, d)}}
        return head({"ln1": torch.ones(L, d, **kw), "ln2": torch.ones(L, d, **kw),
                     "attn": attn, **ffn})

    # ----------------------------------------------------------------- cache
    # families whose cache is a stacked (L, B, S, Hkv, D) K/V pair, which the
    # paged pool can host (the reference's list; vlm is ROADMAP A14d).  MLA
    # caches latents and stays dense
    PAGED_FAMILIES = ("dense", "moe", "vlm")

    def supports_paged(self) -> bool:
        return (self.cfg.family in self.PAGED_FAMILIES
                and self.cfg.attn_type != "mla")

    def state_leaves(self, cache: Dict[str, torch.Tensor]) -> tuple:
        """The leaves of a dense ``cache`` that a decode step advances in
        place rather than rewrites (the recurrent families' states): a
        step run twice from the same buffers would advance them twice, so
        a captured step's warm-up puts them back (``StepGraphs.run``'s
        ``restore``).  () for the positional caches."""
        return tuple(cache[n] for n in SSM_STATE + HYBRID_STATE if n in cache)

    def init_cache(self, batch_size: int, max_seq: int, *, layout: str = "dense",
                   page_size: int = 16, num_pages: Optional[int] = None,
                   kv_dtype: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """'dense': {"k"/"v": (L, B, max_seq, Hkv, D)}, or for MLA
        {"latent": (L, B, max_seq, kv_lora_rank), "rope": (L, B, max_seq,
        qk_rope_head_dim)}; RWKV6's states {"shift_tm"/"shift_cm": (L, B,
        d), "wkv": (L, B, H, hs, hs) fp32}; the hybrid's {"conv": (L, B,
        K - 1, d_in + 2n), "ssm": (L, B, nh, hd, n) fp32, "attn_k"/"attn_v":
        (n_groups, B, max_seq, Hkv, D)}.  'paged' (dense and MoE GQA only:
        ``ValueError``): a shared
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
            if not self.supports_paged():
                raise ValueError(
                    f"paged cache layout supports families "
                    f"{self.PAGED_FAMILIES} (non-MLA); got "
                    f"{cfg.family}/{cfg.attn_type}")
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
        kw = dict(dtype=self.dtype, device=self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        d = cfg.d_model
        if cfg.family == "ssm":
            hs = cfg.rwkv_head_size
            return {"shift_tm": torch.zeros((L, b, d), **kw),
                    "wkv": torch.zeros((L, b, d // hs, hs, hs), **f32),
                    "shift_cm": torch.zeros((L, b, d), **kw)}
        if cfg.family == "hybrid":
            d_in = cfg.ssm_expand * d
            kv = (cfg.n_layers // cfg.hybrid_attn_every, b, max_seq, cfg.n_kv_heads,
                  cfg.d_head)
            return {"conv": torch.zeros((L, b, cfg.ssm_conv - 1, d_in + 2 * cfg.ssm_state),
                                        **kw),
                    "ssm": torch.zeros((L, b, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim,
                                        cfg.ssm_state), **f32),
                    "attn_k": torch.zeros(kv, **kw), "attn_v": torch.zeros(kv, **kw)}
        if cfg.attn_type == "mla":
            return {"latent": torch.zeros((L, b, max_seq, cfg.kv_lora_rank), **kw),
                    "rope": torch.zeros((L, b, max_seq, cfg.qk_rope_head_dim), **kw)}
        shape = (L, b, max_seq, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}

    # --------------------------------------------------------------- pieces
    def _norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, w, self.cfg.norm_eps, self.use_kernels, self.wf)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(self.dtype)

    def head_weight(self, params) -> torch.Tensor:
        """The (d, vocab_padded) head: ``embed.T`` when tied (the
        reference's ``_head`` and train step), else ``lm_head``."""
        return params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm and head, float32 logits over ``vocab_padded``
        columns: every caller trims to ``cfg.vocab`` before the logits
        leave the model (the sampler, the captured steps' argmax and the
        spec step's acceptance never see the padding)."""
        x = self._norm(x, params["ln_f"])
        return (x @ self.head_weight(params).to(x.dtype)).float()

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

    def _attn_block_kv(self, p, g: torch.Tensor):
        """A layer's causal attention over positions 0..S-1 and the rows
        its dense cache keeps, in ``init_cache``'s leaf order: (k, v), or
        MLA's (latent, k_rope)."""
        if self.cfg.attn_type == "mla":
            return mla_block_kv(p, g, self.cfg, use_kernel=self.attn_kernel,
                                norm_kernel=self.use_kernels)
        return gqa_block_kv(p, g, self.cfg, use_kernel=self.attn_kernel)

    def _tf_block(self, p, x: torch.Tensor) -> torch.Tensor:
        """One training layer: causal attention over the whole sequence
        and the MLP, both pre-norm residual (the reference's
        ``_tf_block``)."""
        g = self._norm(x, p["ln1"])
        if self.cfg.attn_type == "mla":
            x = x + mla_block(p["attn"], g, self.cfg, use_kernel=self.attn_kernel,
                              norm_kernel=self.use_kernels)
        else:
            x = x + gqa_block(p["attn"], g, self.cfg, use_kernel=self.attn_kernel)
        return self._mlp_residual(p, x, self.cfg.capacity_factor)

    def _rwkv_block(self, p, x: torch.Tensor, state: Optional[dict] = None):
        """One RWKV6 layer (the reference's ``_rwkv_block``): the time mix
        and the channel mix, each pre-norm residual, continuing from
        ``state`` (the layer's ``SSM_STATE`` leaves, None: zeros).
        Returns (x, the new states by leaf name)."""
        st_tm = None if state is None else (state["shift_tm"], state["wkv"])
        att, (shift_tm, wkv) = rwkv6_time_mix(p["tm"], self._norm(x, p["ln1"]),
                                              self.cfg, st_tm,
                                              use_kernel=self.use_kernels)
        x = x + att
        st_cm = None if state is None else state["shift_cm"]
        ffn, shift_cm = rwkv6_channel_mix(p["tm"], self._norm(x, p["ln2"]),
                                          self.cfg, st_cm)
        return x + ffn, {"shift_tm": shift_tm, "wkv": wkv, "shift_cm": shift_cm}

    def _mamba_block(self, p, x: torch.Tensor, state: Optional[dict] = None):
        """One Mamba2 layer, pre-norm residual, continuing from ``state``
        (``HYBRID_STATE`` leaves, None: zeros).  Returns (x, new states)."""
        st = None if state is None else (state["conv"], state["ssm"])
        y, (conv, ssm) = mamba2_mix(p["mamba"], self._norm(x, p["ln"]), self.cfg, st,
                                    use_kernel=self.use_kernels)
        return x + y, {"conv": conv, "ssm": ssm}

    def _shared_attn_kv(self, params, x: torch.Tensor):
        """The hybrid's shared block over positions 0..S-1: causal GQA
        attention and the SwiGLU MLP, each pre-norm residual.  Returns (x,
        (k, v)) with the rows the group's cache keeps."""
        sp = params["shared_attn"]
        att, kv = gqa_block_kv(sp["attn"], self._norm(x, sp["ln1"]), self.cfg,
                               use_kernel=self.attn_kernel)
        x = x + att
        m = sp["mlp"]
        return x + swiglu(self._norm(x, sp["ln2"]), m["w_gate"], m["w_up"],
                          m["w_down"]), kv

    def _groups(self, params):
        """The hybrid's groups: (group index, the k layers' params) with k
        = ``cfg.hybrid_attn_every``, over n_layers // k groups."""
        k = self.cfg.hybrid_attn_every
        layers = _unstack(params["layers"])
        return [(gi, layers[gi * k:(gi + 1) * k])
                for gi in range(self.cfg.n_layers // k)]

    # -------------------------------------------------------------- forward
    def _layer(self, fn, *args):
        """``fn(*args)``, recomputed in the backward pass with ``remat``
        (no randomness inside a layer: nothing to replay)."""
        if self.remat:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)

    def backbone(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Hidden states (B, S, d) for batch["tokens"] (B, S), no final
        norm and no head, with autograd: the train step feeds them to a
        vocab-chunked loss.  With ``remat`` each layer is recomputed in
        the backward pass (its attention kernel included; the hybrid's
        shared block is not, as in the reference's ``_hybrid_forward``)."""
        x = self._embed(params, batch["tokens"].to(self.device))
        family = self.cfg.family
        if family == "ssm":
            for p in _unstack(params["layers"]):
                x = self._layer(lambda p_, x_: self._rwkv_block(p_, x_)[0], p, x)
            return x
        if family == "hybrid":
            for _, group in self._groups(params):
                x = self._shared_attn_kv(params, x)[0]
                for p in group:
                    x = self._layer(lambda p_, x_: self._mamba_block(p_, x_)[0], p, x)
            return x
        for p in _unstack(params["layers"]):
            x = self._layer(self._tf_block, p, x)
        return x

    def forward(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Logits (B, S, V) in float32 for batch["tokens"] (B, S)."""
        return self._head(params, self.backbone(params, batch))[..., :self.cfg.vocab]

    # --------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, max_seq: int,
                last_pos: Optional[torch.Tensor] = None):
        """tokens (B, S) -> (logits (B, V) at each row's last real token,
        dense cache {"k"/"v": (L, B, max(max_seq, S), Hkv, D)}, or MLA's
        latent cache, with positions [0, S) filled and the rest zero).

        last_pos (B,): index of each row's last real token in a
        right-padded batch; the causal mask keeps it independent of the
        padding, so its logits are exact.  Not so for the MoE family,
        whose expert capacity depends on the row's length: its rows are
        prefilled alone at their exact length (``ServeEngine``)."""
        cfg = self.cfg
        tokens = tokens.to(self.device)
        b, s = tokens.shape
        x = self._embed(params, tokens)
        cache = self.init_cache(b, max(max_seq, s))
        if cfg.family in ("ssm", "hybrid"):
            x = self._prefill_recurrent(params, x, cache)
            return self._head(params, self._last(x, last_pos))[:, 0, :cfg.vocab], cache
        for l, p in enumerate(_unstack(params["layers"])):
            g = self._norm(x, p["ln1"])
            att, rows = self._attn_block_kv(p["attn"], g)
            x = x + att
            for leaf, r in zip(cache.values(), rows):
                leaf[l, :, :s] = r
            x = self._mlp_residual(p, x, cfg.infer_capacity_factor)
        return self._head(params, self._last(x, last_pos))[:, 0, :cfg.vocab], cache

    def _last(self, x: torch.Tensor, last_pos: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, 1, d): each row's hidden at ``last_pos`` (None: the last)."""
        if last_pos is None:
            return x[:, -1:]
        rows = torch.arange(x.shape[0], device=self.device)
        return x[rows, last_pos.to(self.device).long()][:, None]

    def _prefill_recurrent(self, params, x: torch.Tensor, cache) -> torch.Tensor:
        """The recurrent families' prefill layer loop: every layer runs
        from a zero state and leaves its final state in the cache (the
        state after the batch's last position, padding included: the
        engine prefills these families one request at its exact length);
        the hybrid's shared block writes each group's K/V rows [0, S).
        Returns the hidden (B, S, d)."""
        if self.cfg.family == "ssm":
            for l, p in enumerate(_unstack(params["layers"])):
                x, st = self._rwkv_block(p, x)
                for name in SSM_STATE:
                    cache[name][l] = st[name]
            return x
        s = x.shape[1]
        k = self.cfg.hybrid_attn_every
        for gi, group in self._groups(params):
            x, (kk, vv) = self._shared_attn_kv(params, x)
            cache["attn_k"][gi, :, :s] = kk
            cache["attn_v"][gi, :, :s] = vv
            for j, p in enumerate(group):
                x, st = self._mamba_block(p, x)
                for name in HYBRID_STATE:
                    cache[name][gi * k + j] = st[name]
        return x

    # ---------------------------------------------------------------- decode
    @torch.no_grad()
    def decode_step(self, params, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: torch.Tensor,
                    attend_len: Optional[int] = None):
        """tokens (B,) int; pos (B,) positions.  Returns (logits (B, V),
        cache) with each row's K/V written at ``pos`` in place.

        attend_len: bound on the valid cache prefix (max(pos) < attend_len)
        so attention reads only the live part of the cache.  A paged cache
        (``k_pages`` leaf) writes through its block tables instead; MLA
        writes its latent and rope rows and attends in the latent space.
        The recurrent families write each layer's new state over the old
        one (RWKV6 ignores ``pos``; the hybrid's shared attention writes
        its K/V row at ``pos`` in each group's cache)."""
        x = self._embed(params, tokens[:, None])
        if "k_pages" in cache:
            return self._gqa_decode_paged(params, cache, x, pos, attend_len)
        if self.cfg.family == "ssm":
            return self._ssm_decode(params, cache, x)
        if self.cfg.family == "hybrid":
            return self._hybrid_decode(params, cache, x, pos, attend_len)
        if self.cfg.attn_type == "mla":
            return self._mla_decode(params, cache, x, pos, attend_len)
        return self._gqa_decode_unrolled(params, cache, x, pos, attend_len)

    def _ssm_decode(self, params, cache, x):
        """RWKV6's step (the reference's ``ssm`` branch): each layer's
        states advance one token and are copied over the cache's in place,
        so a CUDA graph captures the step."""
        for l, p in enumerate(_unstack(params["layers"])):
            x, st = self._rwkv_block(p, x, {name: cache[name][l] for name in SSM_STATE})
            for name in SSM_STATE:
                cache[name][l].copy_(st[name])
        return self._head(params, x)[:, 0, :self.cfg.vocab], cache

    def _hybrid_decode(self, params, cache, x, pos, attend_len):
        """Zamba2's step (the reference's ``_hybrid_decode``): each group's
        shared block writes its K/V row at ``pos`` in the group's dense
        cache and attends the live prefix (``attend_len``), then its k
        Mamba2 layers advance their states in place."""
        cfg, sp = self.cfg, params["shared_attn"]
        ck, cv = cache["attn_k"], cache["attn_v"]
        b = x.shape[0]
        bidx = torch.arange(b, device=self.device)
        # a finished slot coasting may run past the cache: its write clamps
        # onto the last row, which no live row reads
        row = torch.clamp(pos.long(), max=ck.shape[2] - 1)
        rope = rope_freqs(cfg.d_head, cfg.rope_theta, pos[:, None])
        k = cfg.hybrid_attn_every
        for gi, group in self._groups(params):
            g = self._norm(x, sp["ln1"])
            q, kk, vv = gqa_qkv(sp["attn"], g, cfg, pos[:, None], rope=rope)
            ck[gi, bidx, row] = kk[:, 0]
            cv[gi, bidx, row] = vv[:, 0]
            o = decode_attention(q, ck[gi], cv[gi], pos, attend_len=attend_len,
                                 use_kernel=self.use_kernels)
            x = x + o.reshape(b, 1, -1) @ sp["attn"]["wo"].to(x.dtype)
            m = sp["mlp"]
            x = x + swiglu(self._norm(x, sp["ln2"]), m["w_gate"], m["w_up"], m["w_down"])
            for j, p in enumerate(group):
                l = gi * k + j
                x, st = self._mamba_block(p, x, {name: cache[name][l] for name in HYBRID_STATE})
                for name in HYBRID_STATE:
                    cache[name][l].copy_(st[name])
        return self._head(params, x)[:, 0, :cfg.vocab], cache

    def _mla_decode(self, params, cache, x, pos, attend_len):
        """The MLA step (the reference's unrolled ``mla_decode_block``
        loop): each layer writes its cache rows in place; no host sync and
        no data-dependent shape, so a CUDA graph captures it."""
        lat, rope = cache["latent"], cache["rope"]
        for l, p in enumerate(_unstack(params["layers"])):
            g = self._norm(x, p["ln1"])
            x = x + mla_decode_block(p["attn"], g, self.cfg, lat[l], rope[l], pos,
                                     attend_len=attend_len, use_kernel=self.use_kernels)
            x = self._mlp_residual(p, x, self.cfg.infer_capacity_factor)
        return self._head(params, x)[:, 0, :self.cfg.vocab], cache

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
        quantized, as :meth:`_gqa_decode_paged`.  It backs both the
        speculative verify (:meth:`decode_verify_step`) and the shared
        prefix's suffix prefill (:meth:`prefill_suffix`), so their
        arithmetic is one."""
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

    # ------------------------------------------------- shared-prefix prefill
    @torch.no_grad()
    def prefill_suffix(self, params, cache: Dict[str, torch.Tensor],
                       tokens: torch.Tensor, start_pos: torch.Tensor,
                       last_idx: torch.Tensor, attend_len: Optional[int] = None,
                       verify_backend: Optional[str] = None):
        """Prefill only the un-cached suffix of a prompt whose prefix pages
        are mapped already (prefix sharing: the cached positions' K/V sit in
        pages other slots share, reached through this slot's block table).

        tokens (B, T): right-padded suffixes; row b's real tokens sit at
        positions start_pos[b] .. start_pos[b] + last_idx[b], last_idx[b]
        the index of its last real token in the window.  Returns (logits
        (B, V) at each row's last real token, cache).

        The speculative window aimed at admission: each suffix row's K/V
        is written through the block tables (shared prefix pages are never
        written: the plan puts the suffix past them), each query row
        attends the cached prefix and the window causally, and only T
        tokens are computed.  Padding rows past last_idx land in the
        slot's private tail page or in the trash page.  A window of T * G
        > 32 rows a KV head runs the long-window branch of
        ``paged_flash_verify``."""
        if "k_pages" not in cache:
            raise ValueError("prefill_suffix needs a paged cache "
                             "(k_pages/v_pages/block_tables); got leaves "
                             f"{sorted(cache)}")
        x = self._embed(params, tokens.to(self.device))
        x, cache = self._paged_window(params, cache, x, start_pos.to(self.device),
                                      attend_len, verify_backend)
        rows = torch.arange(x.shape[0], device=self.device)
        last = x[rows, last_idx.to(self.device).long()][:, None]
        return self._head(params, last)[:, 0, :self.cfg.vocab], cache
