"""olmoe-1b-7b [arXiv:2409.02060; hf]: 16L d_model=2048 16H (MHA kv=16)
d_ff=1024/expert vocab=50304, 64 experts top-8."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50_304,
    attn_pattern=("global+moe",),
    n_experts=64,
    top_k=8,
    mlp_gated=True,
    act="silu",
    qk_norm=True,
    tie_embeddings=False,
    supports_long_context=False,
)
