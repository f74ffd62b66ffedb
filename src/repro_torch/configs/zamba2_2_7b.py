"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,            # mamba2 layers
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    hybrid_attn_every=6,    # one shared attn block per 6 mamba layers
)
