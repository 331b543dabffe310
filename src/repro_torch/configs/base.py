"""Unified model configuration for the assigned architecture pool.

One ``ModelConfig`` describes any of the 10 assigned architectures; the
layer plan (``layer_kinds``, ``layer_plan``) drives the layer stack that
``repro_torch.models.lm`` assembles.  The port keeps its own copy of the
JAX package's configuration values.  ``input_specs`` produces ``meta``
tensors standing in for every (shape-cell x step) without allocating
memory: the lowering proofs (``repro_torch.launch.dryrun``) trace against
them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

__all__ = ["ModelConfig", "SHAPE_CELLS", "input_specs", "reduce_for_smoke"]

# assigned LM shape set: name -> (seq_len, global_batch, step)
SHAPE_CELLS = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention behaviour
    attn_pattern: tuple[str, ...] = ("global",)   # per-layer cycle
    window: int = 4_096                           # local-attention window
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    rope_theta: float = 10_000.0
    rope_local_theta: float | None = None         # gemma3: local layers theta
    qk_norm: bool = False
    mrope_sections: tuple[int, int, int] | None = None   # qwen2-vl M-RoPE

    # MLP
    mlp_gated: bool = True
    act: str = "silu"                             # silu | gelu
    post_block_norm: bool = False                 # gemma2 post-norms

    # MoE (family == moe); "moe" layers in attn_pattern use these
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dense_ff: int = 0                         # d_ff of interleaved dense layers
    capacity_factor: float = 1.25

    # SSM / Mamba2 (family in {hybrid, ssm})
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # RWKV6
    rwkv_head_size: int = 0

    # hybrid (zamba2): weight-tied attention block applied every N layers
    shared_block_period: int = 0

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub: none | patches | frames
    frontend: str = "none"

    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # long-context applicability: archs with only full attention skip long_500k
    supports_long_context: bool = False

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def layer_kinds(self) -> list[str]:
        """Per-layer kind: attention flavour / moe / mamba2 / rwkv6."""
        kinds = []
        for i in range(self.n_layers):
            kinds.append(self.attn_pattern[i % len(self.attn_pattern)])
        return kinds

    def layer_plan(self) -> tuple[tuple[str, ...], int, tuple[str, ...]]:
        """(cycle kinds, n_scan_groups, tail kinds): scan over whole cycles,
        unroll the remainder."""
        cyc = tuple(self.attn_pattern)
        n_groups = self.n_layers // len(cyc)
        tail = tuple(self.layer_kinds()[n_groups * len(cyc):])
        return cyc, n_groups, tail

    def supports_cell(self, cell: str) -> str | None:
        """None if the cell applies; otherwise the reason for skipping."""
        seq, batch, step = SHAPE_CELLS[cell]
        if cell == "long_500k" and not self.supports_long_context:
            return ("pure full-attention architecture: 500k decode needs "
                    "sub-quadratic attention (DESIGN.md §Arch-applicability)")
        return None


def input_specs(cfg: ModelConfig, cell: str) -> dict[str, torch.Tensor]:
    """``meta`` tensors standing in for one (arch x shape-cell)'s inputs:
    the reference's keys, shapes and dtypes (ids ``torch.int32``,
    embeddings in the config's dtype)."""
    return step_specs(cfg, *SHAPE_CELLS[cell])


def step_specs(cfg: ModelConfig, seq: int, batch: int,
               step: str) -> dict[str, torch.Tensor]:
    """:func:`input_specs` of a (seq, batch, step) that need not be one of
    ``SHAPE_CELLS``."""
    f = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def s(shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")

    if step == "decode":
        # one new token against a cache of length seq
        out = {"token": s((batch, 1)), "pos": s((batch,))}
        if cfg.mrope_sections:
            out["positions"] = s((3, batch, 1))
        return out
    labels = {"labels": s((batch, seq))} if step == "train" else {}
    if cfg.enc_dec:
        return {"frames": s((batch, seq, cfg.d_model), f),
                "tokens": s((batch, seq)), **labels}
    if cfg.frontend == "patches":
        n_vis = min(1024, seq // 4)
        out = {"tokens": s((batch, seq - n_vis)),
               "patch_embeds": s((batch, n_vis, cfg.d_model), f), **labels}
        if cfg.mrope_sections:
            out["positions"] = s((3, batch, seq))
        return out
    return {"tokens": s((batch, seq)), **labels}


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    cyc = len(cfg.attn_pattern)
    n_layers = max(cyc, 2 if cyc == 1 else cyc)
    if cfg.shared_block_period:
        n_layers = cfg.shared_block_period
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        window=8,
        n_enc_layers=min(cfg.n_enc_layers, 2),
    )
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.moe_dense_ff:
        kw.update(moe_dense_ff=256)
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_heads=4, ssm_expand=2)
    if cfg.rwkv_head_size:
        kw.update(rwkv_head_size=16)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(2, 3, 3))   # sums to head_dim/2 = 8
    return replace(cfg, **kw)
