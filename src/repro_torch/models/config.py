"""Model configuration (the dense-family fields of ``repro``'s
``ModelConfig``; later families add theirs when they are ported)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported so far)
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

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))
