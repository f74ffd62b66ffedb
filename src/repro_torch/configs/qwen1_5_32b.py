"""Qwen1.5-32B [hf:Qwen family] — dense, QKV bias."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
)
