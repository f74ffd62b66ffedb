"""Model configuration: the fields of ``repro``'s ``ModelConfig`` that the
ported families read (dense and MoE: the GQA shape, q/k/v biases, RoPE,
the experts and their capacities; MLA's latent ranks and head dims;
RWKV6's head size, Mamba2's state, expansion, head dim and conv width,
and the hybrid's interleave of one shared attention block) and
the layer options they take (a padded vocabulary, tied embeddings, a bf16
P·V contraction on the plain attention path).  Later families add their
fields when they are ported."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid (ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None   # default d_model // n_heads

    attn_type: str = "gqa"         # gqa | mla | none (the ssm family)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # MLA (MiniCPM3 / DeepSeek-V2 style): q and K/V through low-rank
    # latents; q/k heads of nope + rope dims, v heads of v_head_dim
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    infer_capacity_factor: float = 2.0   # prefill/decode capacity (no-drop
                                         # margin without training's budget)

    # SSM / recurrent: RWKV6 (family "ssm") and Mamba2 (the hybrid's layers)
    rwkv_head_size: int = 64
    ssm_state: int = 64
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # hybrid (Zamba2): one shared attention block before every k Mamba2
    # layers
    hybrid_attn_every: int = 6

    # layer options
    tie_embeddings: bool = False   # no lm_head: the head is embed.T
    pv_bf16: bool = False          # the plain attention path contracts the
                                   # softmax probabilities with V in bf16
                                   # (scores, max and sum stay fp32); the
                                   # kernel path ignores it
    moe_group_size: int = 0        # >0: dispatch in token groups of this
                                   # size (GShard grouping: the dispatch
                                   # tensor grows linearly, not
                                   # quadratically, in sequence length)
    pad_vocab_to: int = 0          # >0: embed rows and head columns padded
                                   # to a multiple of this; every logits
                                   # site trims to ``vocab`` and the loss
                                   # masks the padding

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Rows of ``embed`` and columns of ``lm_head``: ``vocab`` rounded
        up to a multiple of ``pad_vocab_to`` (``vocab`` when it is 0)."""
        if self.pad_vocab_to <= 0:
            return self.vocab
        m = self.pad_vocab_to
        return -(-self.vocab // m) * m
