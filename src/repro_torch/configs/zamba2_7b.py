"""zamba2-7b [arXiv:2411.15242; unverified]: 81L d_model=3584 Mamba2
backbone (ssm_state=64) with a weight-tied shared attention+MLP block
(32H kv=32, d_ff=14336) applied every 6th layer — hybrid SSM/attention."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab=32_000,
    attn_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                  "mamba2+shared"),
    shared_block_period=6,
    ssm_state=64,
    ssm_heads=112,     # d_inner = 2*3584 = 7168; head dim 64
    ssm_expand=2,
    ssm_conv=4,
    mlp_gated=True,
    act="silu",
    tie_embeddings=True,
    supports_long_context=True,   # hybrid: run long_500k
)
