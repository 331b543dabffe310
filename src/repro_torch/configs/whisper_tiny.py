"""whisper-tiny [arXiv:2212.04356; unverified]: enc-dec, 4L each,
d_model=384 6H d_ff=1536 vocab=51865 — conv frame frontend STUBBED
(input_specs supplies precomputed frame embeddings), sinusoidal positions,
cross attention in the decoder.  Shapes follow the assigned stand-in sequence
lengths, not the production 1500-frame/448-token limits (DESIGN.md)."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51_865,
    attn_pattern=("global",),
    enc_dec=True,
    n_enc_layers=4,
    frontend="frames",
    mlp_gated=False,
    act="gelu",
    tie_embeddings=True,
    supports_long_context=False,
)
