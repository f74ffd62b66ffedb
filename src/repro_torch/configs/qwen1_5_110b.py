"""Qwen1.5-110B [hf:Qwen family] — dense GQA, QKV bias."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    qkv_bias=True,
)
