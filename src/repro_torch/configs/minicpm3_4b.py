"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B] — dense with MLA attention."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attn_type="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_head_dim=64,
    qk_rope_head_dim=32,
    v_head_dim=64,
)
