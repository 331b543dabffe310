"""h2o-danube-1.8b [arXiv:2401.16818; hf]: 24L d_model=2560 32H (GQA kv=8)
d_ff=6912 vocab=32000 — llama architecture + mistral-style sliding-window
attention."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32_000,
    attn_pattern=("local",),
    window=4_096,
    mlp_gated=True,
    act="silu",
    tie_embeddings=False,
    supports_long_context=True,   # SWA bounds the KV cache
)
