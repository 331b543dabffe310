"""Shared neural layers: RMSNorm, RoPE / M-RoPE / sinusoidal positions,
GQA attention (full / sliding-window, logit softcap, QK-norm, KV cache),
and gated/plain MLPs.

The port of ``repro.models.layers``: the same functions under the same
names, over parameters held by ``nn.Module``s (:class:`Attention`,
:class:`MLP`) whose attribute names are the JAX parameter tree's keys.
Attention logits are float32 whatever the storage type: bf16 operands are
upcast before the product (exact, since a bf16 product fits in float32),
which is what the reference's ``preferred_element_type=float32`` computes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .partitioning import (constrain, is_dtensor, merge_dims, replicate_like,
                           einsum_needs_shards, shard_einsum, split_dim)

__all__ = [
    "rms_norm", "apply_rope", "apply_mrope", "sincos_positions",
    "attention_block", "mlp_block", "Attention", "MLP", "sdpa_chunked",
    "ATTN_Q_CHUNK",
]


def normal_(gen, shape, std: float, dtype, device) -> torch.Tensor:
    """``N(0, std^2)`` drawn in float32 from ``gen``, then cast to ``dtype``
    (the reference draws in float32 and casts the same way)."""
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------- positions


def _rope_angles(positions: torch.Tensor, dims: int,
                 theta: float) -> torch.Tensor:
    """positions [...]; returns [..., dims/2] angles."""
    exps = torch.arange(0, dims, 2, dtype=torch.float32,
                        device=positions.device) / dims
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    return positions.float()[..., None] * replicate_like(freqs, positions)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [..., H, hd]; angles [..., hd/2] broadcast over heads."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = torch.cos(angles)[..., None, :]
    s = torch.sin(angles)[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, S, H, hd]; positions [B, S]."""
    return _rotate(x, _rope_angles(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: positions [3, B, S] (temporal, h, w);
    the hd/2 rotary frequencies are partitioned into three sections, each
    driven by its own position stream."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    angles = []
    for stream, sec in enumerate(sections):
        a = _rope_angles(positions[stream], hd, theta)      # [B, S, hd/2]
        start = sum(sections[:stream])
        angles.append(a[..., start:start + sec])
    return _rotate(x, torch.cat(angles, dim=-1))


def sincos_positions(seq: int, d_model: int, offset: int = 0,
                     device=None) -> torch.Tensor:
    """Whisper-style sinusoidal absolute position embedding [seq, d_model]
    (float32, computed in float64 numpy as the reference does)."""
    pos = np.arange(offset, offset + seq)[:, None]
    dim = np.arange(d_model // 2)[None, :]
    inv = np.exp(-math.log(10000.0) * dim / max(1, d_model // 2 - 1))
    ang = pos * inv
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.tensor(table, dtype=torch.float32, device=device)


# ---------------------------------------------------------------- attention


class Attention(nn.Module):
    """Attention projections (``init_attention``): ``wq [d, q_dim]``,
    ``wk``/``wv [d, kv_dim]``, ``wo [q_dim, d]``, and the QK-norm scales
    where the config has them."""

    def __init__(self, cfg, dtype, device, gen=None):
        super().__init__()
        d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
        sd = 1.0 / math.sqrt(d)
        self.wq = nn.Parameter(normal_(gen, (d, qd), sd, dtype, device))
        self.wk = nn.Parameter(normal_(gen, (d, kvd), sd, dtype, device))
        self.wv = nn.Parameter(normal_(gen, (d, kvd), sd, dtype, device))
        self.wo = nn.Parameter(normal_(gen, (qd, d), 1.0 / math.sqrt(qd),
                                       dtype, device))
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.zeros(cfg.head_dim, dtype=dtype,
                                                   device=device))
            self.k_norm = nn.Parameter(torch.zeros(cfg.head_dim, dtype=dtype,
                                                   device=device))


def _positional(q, k, cfg, kind, positions, k_positions=None):
    if cfg.enc_dec:
        return q, k  # whisper: sinusoidal embeddings added at the stem
    theta = cfg.rope_theta
    if kind == "local" and cfg.rope_local_theta is not None:
        theta = cfg.rope_local_theta
    kp = positions if k_positions is None else k_positions
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, theta, cfg.mrope_sections)
        k = apply_mrope(k, kp, theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, kp, theta)
    return q, k


def _sdpa(q, k, v, mask, cfg):
    """q [B,S,H,hd]; k/v [B,T,KV,hd]; mask [B,1,1,S,T] or broadcastable.

    Logits and the PV product accumulate in float32: bf16 operands are
    upcast first (their products are exact in float32) and the output is
    cast back to ``v``'s type, as the reference's ``preferred_element_type``
    products do.  At decode this makes a float32 copy of the layer's KV
    cache for the step."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    q = split_dim(q, 2, (KV, rep))
    qf, kf = q.float(), k.float()
    if is_dtensor(q) and (any(p.is_shard(1) for p in q.placements) or not
                          einsum_needs_shards("bsgrh,btgh->bgrst", qf, kf)):
        # the query rows ahead of the head group, so that sharded rows
        # (sequence-parallel attention) lead the dims the product flattens
        logits = torch.einsum("bsgrh,btgh->bgsrt", qf,
                              kf).transpose(2, 3) / math.sqrt(hd)
        pv = torch.einsum
    else:
        # per shard, where torch's einsum would flatten a shard that does
        # not lead its group (the batch and the head groups both sharded)
        logits = shard_einsum("bsgrh,btgh->bgrst", qf, kf) / math.sqrt(hd)
        pv = shard_einsum
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = torch.tanh(logits / c) * c
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = pv("bgrst,btgh->bsgrh", w.to(v.dtype).float(), v.float())
    return merge_dims(out, 2, 4).to(v.dtype)


ATTN_Q_CHUNK = 512


def sdpa_chunked(q, k, v, cfg, mask_fn, q_offset: int = 0,
                 chunk: int = ATTN_Q_CHUNK, local_window: int | None = None):
    """Memory-bounded attention: a loop over query chunks, so the [S, T]
    logits never materialise (one [chunk, T] slab per head group is live).

    For sliding-window layers (``local_window``, with window + chunk < T),
    each chunk reads only the [window + chunk] K/V band it can attend.  A
    last chunk shorter than ``chunk`` takes the band that ends at T, and
    its key positions are those of the band it took (the reference's
    clamped slice keeps the unclamped positions there; see ROADMAP.md,
    queue 3).

    mask_fn(qpos [Cq], kpos [T]) -> bool [Cq, T]; q [B,S,H,hd]; k/v [B,T,..].
    """
    B, S, H, hd = q.shape
    T = k.shape[1]
    dev = q.device

    def arange(*a):
        return replicate_like(torch.arange(*a, device=dev), q)

    if S <= chunk:
        mask = mask_fn(arange(S) + q_offset, arange(T))
        return _sdpa(q, k, v, mask[None, None, None, :, :], cfg)
    assert q_offset == 0, "banded path assumes self-attention alignment"
    kpos = arange(T)

    band = None
    if local_window is not None and local_window + chunk < T:
        W = local_window
        band = W + chunk
        # W zero rows in front (a concatenation: DTensor's pad fails in
        # some torch versions)
        kpad = torch.cat([torch.zeros_like(k[:, :1]).expand(
            -1, W, -1, -1), k], dim=1)
        vpad = torch.cat([torch.zeros_like(v[:, :1]).expand(
            -1, W, -1, -1), v], dim=1)

    # whole chunks stack on a leading axis, as in the reference, whose
    # "attn_chunks" spec keeps each chunk's slice on its shard
    qs = None
    if S % chunk == 0:
        qs = constrain(split_dim(q, 1, (S // chunk, chunk)).transpose(0, 1),
                       "attn_chunks")

    def one(qstart: int, qend: int):
        qc = q[:, qstart:qend] if qs is None else qs[qstart // chunk]
        # per-chunk sequence parallelism: the chunk's rows over the model
        # axis (set when head counts do not divide it)
        qc = constrain(qc, "attn_chunk")
        qpos = arange(qstart, qend) + q_offset
        if band is not None:
            kk = kpad[:, qstart:qstart + band]
            vv = vpad[:, qstart:qstart + band]
            kp = qstart - W + arange(kk.shape[1])
            mask = mask_fn(qpos, kp)             # pads land at kp < 0
            return _sdpa(qc, kk, vv, mask[None, None, None, :, :], cfg)
        mask = mask_fn(qpos, kpos)
        return _sdpa(qc, k, v, mask[None, None, None, :, :], cfg)

    return torch.cat([one(s, min(s + chunk, S))
                      for s in range(0, S, chunk)], dim=1)


def attention_block(p: Attention, x: torch.Tensor, cfg, kind: str,
                    positions: torch.Tensor, *, causal: bool = True,
                    cache: dict | None = None,
                    cache_pos: torch.Tensor | None = None,
                    kv_from: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None):
    """One attention op.

    Modes:
      * full-sequence (train / prefill): ``cache is None`` — returns
        (out, {"k","v"}) so prefill can build a cache;
      * incremental decode: ``cache`` holds [B, Smax, KV, hd]; the new k/v is
        written at ``cache_pos`` (into new tensors: the given cache is not
        changed) and attention runs over the whole cache;
      * cross attention: ``kv_from`` supplies the keys/values source
        (encoder output), no causal mask.
    """
    B, S, d = x.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    src = x if kv_from is None else kv_from
    q = (x @ p.wq).reshape(B, S, H, hd)
    k = (src @ p.wk).reshape(B, src.shape[1], KV, hd)
    v = (src @ p.wv).reshape(B, src.shape[1], KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if kv_from is None:
        q, k = _positional(q, k, cfg, kind, positions, kv_positions)

    if cache is not None and kv_from is None:
        bidx = torch.arange(B, device=x.device)
        ck = cache["k"].clone()
        cv = cache["v"].clone()
        ck[bidx, cache_pos] = k[:, 0]
        cv[bidx, cache_pos] = v[:, 0]
        T = ck.shape[1]
        tpos = torch.arange(T, device=x.device)[None, :]       # [1, T]
        mask = tpos <= cache_pos[:, None]
        if kind == "local":
            mask = mask & (tpos > cache_pos[:, None] - cfg.window)
        mask = mask[:, None, None, None, :]                     # [B,1,1,1,T]
        out = _sdpa(q, ck, cv, mask, cfg)
        return out @ p.wo, {"k": ck, "v": cv}

    T = src.shape[1]
    if kv_from is not None:
        mask = torch.ones((1, 1, 1, S, T), dtype=torch.bool, device=x.device)
    else:
        qpos = positions[..., :, None] if positions.ndim == 2 else \
            torch.arange(S, device=x.device)[:, None]
        kpos = torch.arange(T, device=x.device)[None, :]
        if causal:
            mask = kpos <= qpos
            if kind == "local":
                mask = mask & (kpos > qpos - cfg.window)
        else:
            mask = torch.ones((S, T), dtype=torch.bool, device=x.device)
            if kind == "local":
                mask = torch.abs(kpos - qpos) < cfg.window
        mask = mask[..., None, None, :, :] if mask.ndim == 3 else \
            mask[None, None, None, :, :]
    out = _sdpa(q, k, v, mask, cfg)
    return out @ p.wo, {"k": k, "v": v}


# ---------------------------------------------------------------- MLP


class MLP(nn.Module):
    """``init_mlp``: ``w_up [d, ff]``, ``w_down [ff, d]`` and, gated,
    ``w_gate [d, ff]``."""

    def __init__(self, d_model: int, d_ff: int, gated: bool, dtype, device,
                 gen=None):
        super().__init__()
        si, so = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
        self.w_up = nn.Parameter(normal_(gen, (d_model, d_ff), si, dtype,
                                         device))
        self.w_down = nn.Parameter(normal_(gen, (d_ff, d_model), so, dtype,
                                           device))
        if gated:
            self.w_gate = nn.Parameter(normal_(gen, (d_model, d_ff), si,
                                               dtype, device))


def _act(act: str):
    """``silu``, or the reference's ``jax.nn.gelu``, whose default is the
    tanh approximation."""
    if act == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def mlp_block(p: MLP, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    f = _act(act)
    if hasattr(p, "w_gate"):
        return (f(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    return f(x @ p.w_up) @ p.w_down
