"""starcoder2-15b [arXiv:2402.19173; hf]: 40L d_model=6144 48H (GQA kv=4)
d_ff=24576 vocab=49152 — full attention + RoPE, plain GELU MLP."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab=49_152,
    attn_pattern=("global",),
    mlp_gated=False,
    act="gelu",
    tie_embeddings=False,
    supports_long_context=False,  # pure full attention: long_500k skipped
)
