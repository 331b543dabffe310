"""gemma2-2b [arXiv:2408.00118; hf]: 26L d_model=2304 8H (GQA kv=4)
d_ff=9216 vocab=256000 — 1:1 local:global alternation, attention and final
logit softcaps, pre+post block RMSNorm, GeGLU."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    attn_pattern=("local", "global"),
    window=4_096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_gated=True,
    act="gelu",
    post_block_norm=True,
    tie_embeddings=True,
    supports_long_context=True,   # decode is O(KV); local layers bounded
)
