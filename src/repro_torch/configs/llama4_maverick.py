"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-Maverick-17B-128E;
unverified]: 48L d_model=5120 40H (GQA kv=8) vocab=202048, MoE 128 experts
top-1 + shared expert (d_ff=8192 each), alternating with dense layers
(d_ff=16384) so totals match 400B/17B-active — see DESIGN.md for the
interpretation of the assigned config.  Full attention + RoPE as assigned."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202_048,
    attn_pattern=("global+moe", "global"),
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    moe_dense_ff=16_384,
    mlp_gated=True,
    act="silu",
    tie_embeddings=False,
    supports_long_context=False,
)
