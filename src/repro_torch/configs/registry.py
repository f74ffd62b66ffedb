"""Architecture registry: full configs + reduced (smoke-test) variants.

Only the families the port serves are registered (dense, MoE, MLA, RWKV6
and the Mamba2 hybrid); the rest arrive with their model code."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen32b
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen110b
from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2_15b
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_olmoe, _granite, _qwen110b, _minicpm3, _qwen2_15b,
                        _qwen32b, _rwkv6, _zamba2)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Same structure, laptop-scale dims, as the reference's
    ``reduced_config``: 4 layers (the hybrid two groups of its interleave),
    d_model 256, vocab 512, d_ff 512, or for MoE 128 per expert over 8
    experts, top-k at most 4; 4 query heads keeping the full config's GQA
    group where the config has heads (RWKV6 has none: d_head 256); MLA's
    ranks q 64, kv 32 and head dims nope 32, rope 16, v 32; RWKV6's head
    size 32; Mamba2's state 16 and head dim 32."""
    c = get_config(name)
    changes = dict(n_layers=min(c.n_layers, 4 if c.family != "hybrid"
                                else 2 * c.hybrid_attn_every),
                   d_model=256, vocab=512, d_ff=512, d_head=None)
    if c.n_heads:
        group = max(c.n_heads // max(c.n_kv_heads, 1), 1)
        changes.update(n_heads=4, n_kv_heads=max(4 // group, 1))
    if c.family == "moe":
        changes.update(d_ff=128, n_experts=8, top_k=min(c.top_k, 4))
    if c.attn_type == "mla":
        changes.update(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                       qk_rope_head_dim=16, v_head_dim=32)
    if c.family == "ssm":
        changes["rwkv_head_size"] = 32
    if c.family == "hybrid":
        changes.update(ssm_state=16, ssm_head_dim=32)
    return dataclasses.replace(c, **changes)


def with_kernel_head_dims(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with an MLA config's head dims set back to its full
    config's (MiniCPM3: q/k heads of 64 nope + 32 rope dims, v heads of
    64): the flash kernels are built for that (96, 64) pair, not the
    reduced config's (48, 32).  Any other config comes back unchanged."""
    if cfg.attn_type != "mla":
        return cfg
    full = get_config(cfg.name)
    return dataclasses.replace(cfg, qk_nope_head_dim=full.qk_nope_head_dim,
                               qk_rope_head_dim=full.qk_rope_head_dim,
                               v_head_dim=full.v_head_dim)
