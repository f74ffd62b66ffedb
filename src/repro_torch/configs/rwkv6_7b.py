"""RWKV6-7B (Finch) [arXiv:2404.05892] — attention-free, data-dependent decay."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab=65536,
    attn_type="none",
    rwkv_head_size=64,
)
