"""rwkv6-7b "Finch" [arXiv:2404.05892; hf]: 32L d_model=4096 attention-free
(data-dependent per-channel decay, head size 64), channel-mix d_ff=14336,
vocab=65536."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,        # derived: d_model / rwkv_head_size
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65_536,
    attn_pattern=("rwkv6",),
    rwkv_head_size=64,
    mlp_gated=False,
    act="silu",
    tie_embeddings=False,
    supports_long_context=True,   # linear recurrence
)
