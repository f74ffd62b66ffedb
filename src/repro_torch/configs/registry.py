"""Architecture registry: full configs + reduced (smoke-test) variants.

Only the families the port serves are registered; the rest arrive with
their model code."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite
from repro_torch.configs.olmoe_1b_7b import CONFIG as _olmoe
from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2_15b
from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (_olmoe, _granite, _qwen2_15b)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Same structure, laptop-scale dims (the reference's
    ``reduced_config`` for the dense and MoE families): 4 layers, d_model
    256, 4 query heads keeping the full config's GQA group, vocab 512;
    d_ff 512, or for MoE 128 per expert over 8 experts, top-k at most 4."""
    c = get_config(name)
    group = max(c.n_heads // max(c.n_kv_heads, 1), 1)
    changes = dict(n_layers=min(c.n_layers, 4), d_model=256, vocab=512,
                   d_ff=512, d_head=None, n_heads=4, n_kv_heads=max(4 // group, 1))
    if c.family == "moe":
        changes.update(d_ff=128, n_experts=8, top_k=min(c.top_k, 4))
    return dataclasses.replace(c, **changes)
