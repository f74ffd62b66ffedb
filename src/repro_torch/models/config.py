"""Model configuration (the dense- and MoE-family fields of ``repro``'s
``ModelConfig``; later families add theirs when they are ported)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # default d_model // n_heads

    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    infer_capacity_factor: float = 2.0   # prefill/decode capacity (no-drop
                                         # margin without training's budget)
    moe_group_size: int = 0        # >0: dispatch in token groups of this
                                   # size (GShard grouping: the dispatch
                                   # tensor grows linearly, not
                                   # quadratically, in sequence length)

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
