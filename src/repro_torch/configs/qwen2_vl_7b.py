"""qwen2-vl-7b [arXiv:2409.12191; hf]: 28L d_model=3584 28H (GQA kv=4)
d_ff=18944 vocab=152064 — M-RoPE (temporal/height/width sections), dynamic-
resolution vision frontend STUBBED: input_specs supplies precomputed patch
embeddings."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152_064,
    attn_pattern=("global",),
    mrope_sections=(16, 24, 24),
    frontend="patches",
    mlp_gated=True,
    act="silu",
    tie_embeddings=False,
    supports_long_context=False,
)
