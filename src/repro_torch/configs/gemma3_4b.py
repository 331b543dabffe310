"""gemma3-4b [hf:google/gemma-3-4b-pt; unverified]: 34L d_model=2560 8H
(GQA kv=4) d_ff=10240 vocab=262144 — 5:1 local:global, 1024-token window,
QK-norm, split RoPE thetas (1M global / 10k local)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262_144,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=1_024,
    rope_theta=1_000_000.0,
    rope_local_theta=10_000.0,
    qk_norm=True,
    mlp_gated=True,
    act="gelu",
    post_block_norm=True,
    tie_embeddings=True,
    supports_long_context=True,
)
