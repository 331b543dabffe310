"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mix with
data-dependent per-channel decay, plus channel mix.

The port of ``repro.models.rwkv6``.  Per head (key/value dim = hd):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T            S in R^{hd x hd}
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    w_t = exp(-exp(w0 + lora(x_t)))                (data-dependent decay)

Prefill uses the chunked parallel form (cumulative log-decay products
inside a chunk, the state carried across chunks by a loop); decode is the
single-step recurrence.  The chunk forms ``k * exp(-l)`` in the
reference's order of operations, so where the reference overflows over a
64-step chunk the port overflows the same way.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import normal_, rms_norm
from .partitioning import (align, as_layout, is_dtensor, merge_dims,
                           per_shard, relayout, replicate_like,
                           shard_einsum, split_dim)

__all__ = ["RWKV6", "rwkv6_block", "rwkv6_decode", "init_rwkv6_state"]

CHUNK = 64
LORA = 64


class RWKV6(nn.Module):
    """``init_rwkv6``: token-shift mixes ``mu``/``cmu``, time-mix
    projections, the decay bias ``w0`` and LoRA ``w1``/``w2``, the bonus
    ``u`` (float32), the group norm ``ln_x`` and the channel mix."""

    def __init__(self, cfg, dtype, device, gen=None):
        super().__init__()
        d = cfg.d_model
        hd = cfg.rwkv_head_size
        H = d // hd
        si = 1.0 / math.sqrt(d)
        f32 = torch.float32

        def w(shape, std, dt=dtype):
            return nn.Parameter(normal_(gen, shape, std, dt, device))

        def full(shape, value, dt=dtype):
            return nn.Parameter(torch.full(shape, value, dtype=dt,
                                           device=device))

        self.mu = full((5, d), 0.5)              # shift mix for r,k,v,g,w
        self.wr = w((d, d), si)
        self.wk = w((d, d), si)
        self.wv = w((d, d), si)
        self.wg = w((d, d), si)
        self.wo = w((d, d), si)
        self.w0 = full((d,), -4.0, f32)          # decay bias: slow decay
        self.w1 = w((d, LORA), si)
        self.w2 = w((LORA, d), 1.0 / math.sqrt(LORA))
        self.u = w((H, hd), 0.1, f32)
        self.ln_x = full((d,), 0.0)
        # channel mix
        self.cmu = full((2, d), 0.5)
        self.ck = w((d, cfg.d_ff), si)
        self.cv = w((cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff))
        self.cr = w((d, d), si)


def _shift(x, mu, last):
    """Token shift: mix x_{t-1} (or carry ``last`` for t=0) into x_t."""
    prev = torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)
    return x * mu + prev * (1.0 - mu)


def _wkv_chunked(r, k, v, logw, u, H, hd):
    """r/k/v [B, T, H, hd] (f32); logw [B, T, H, hd] (negative); u [H, hd]."""
    B, T, _, _ = r.shape
    L = min(CHUNK, T)
    assert T % L == 0
    nC = T // L
    # one layout for the four before the scan, not one a chunk
    r, k, v, logw = align(r, k, v, logw)
    strict = replicate_like(torch.tril(torch.ones((L, L), dtype=torch.bool,
                                                  device=r.device),
                                       diagonal=-1), r)

    S = replicate_like(torch.zeros((B, H, hd, hd), dtype=torch.float32,
                                   device=r.device), r)
    ys = []
    for c in range(nC):
        sl = slice(c * L, (c + 1) * L)
        rc, kc, vc, lw = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        l = per_shard(lambda t: torch.cumsum(t, dim=1), lw, 1)  # inclusive
        lprev = l - lw                                     # exclusive
        rt = rc * torch.exp(lprev)                         # r~_t = r_t P_{t-1}
        kt = kc * torch.exp(-l)                            # k~_j = k_j / P_j
        A = shard_einsum("bthc,bjhc->bhtj", rt, kt)        # [B, H, L, L]
        A = torch.where(strict, A, 0.0)
        diag = shard_einsum("bthc,hc,bthc->bth", rc, u, kc)  # bonus u term
        y = shard_einsum("bhtj,bjhd->bthd", A, vc)
        y = y + diag[..., None] * vc
        y = y + shard_einsum("bthc,bhcd->bthd", rt, S)     # inter-chunk
        # S' = diag(P_L) S + sum_j (P_L / P_j) k_j v_j^T
        S = (S * torch.exp(l[:, -1])[..., None] +
             shard_einsum("bjhc,bjhd->bhcd",
                          kc * torch.exp(l[:, -1:] - l), vc))
        ys.append(y)
    return torch.cat(ys, dim=1), S


def _projections(p: RWKV6, x, last, cfg):
    d = cfg.d_model
    hd = cfg.rwkv_head_size
    H = d // hd
    B, T, _ = x.shape
    xr = _shift(x, p.mu[0], last)
    xk = _shift(x, p.mu[1], last)
    xv = _shift(x, p.mu[2], last)
    xg = _shift(x, p.mu[3], last)
    xw = _shift(x, p.mu[4], last)
    r = split_dim(xr @ p.wr, -1, (H, hd)).float()
    k = split_dim(xk @ p.wk, -1, (H, hd)).float()
    v = split_dim(xv @ p.wv, -1, (H, hd)).float()
    g = F.silu(xg @ p.wg)
    # the decay's gradient comes back in its product's layout: sliced
    # chunk by chunk, it would come back sharded on the sequence, which
    # the product's backward then has to flatten
    lora = torch.tanh(xw @ p.w1) @ p.w2
    if is_dtensor(lora):
        lora = relayout(lora, lora.placements)
    logw = -torch.exp(p.w0 + lora.float())
    logw = split_dim(logw, -1, (H, hd))
    return r, k, v, g, logw


def _channel_mix(p: RWKV6, h, clast):
    hk = _shift(h, p.cmu[0], clast)
    hr = _shift(h, p.cmu[1], clast)
    cm = torch.square(F.relu(hk @ p.ck)) @ p.cv
    return torch.sigmoid(hr @ p.cr) * cm


def rwkv6_block(p: RWKV6, x: torch.Tensor, cfg, state=None):
    """Time mix + channel mix over a full sequence. x [B, T, d]."""
    B, T, d = x.shape
    hd = cfg.rwkv_head_size
    H = d // hd
    zeros = torch.zeros_like(x[:, 0, :])
    last = zeros if state is None else state[0]
    r, k, v, g, logw = _projections(p, x, last, cfg)
    y, S = _wkv_chunked(r, k, v, logw, p.u, H, hd)
    y = merge_dims(y, 2, 3).to(x.dtype)
    y = rms_norm(y, p.ln_x, cfg.norm_eps) * g
    out = as_layout(y @ p.wo, x)        # a DTensor's partial sums reduced

    h = x + out
    clast = zeros if state is None else state[2]
    cm = _channel_mix(p, h, clast)
    return out + cm, (x[:, -1, :], S, h[:, -1, :])


def init_rwkv6_state(cfg, batch: int, dtype=None, device=None):
    """(last_x, S, last_h); the token-shift carries in the model's storage
    type (``dtype``, by default the config's), S in float32."""
    d = cfg.d_model
    hd = cfg.rwkv_head_size
    H = d // hd
    if dtype is None:
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return (torch.zeros((batch, d), dtype=dtype, device=device),
            torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, d), dtype=dtype, device=device))


def rwkv6_decode(p: RWKV6, x: torch.Tensor, cfg, state):
    """Single-token step. x [B, 1, d]; state (last_x, S, last_h)."""
    B, _, d = x.shape
    last_x, S, last_h = state
    r, k, v, g, logw = _projections(p, x, last_x, cfg)
    r1, k1, v1 = r[:, 0], k[:, 0], v[:, 0]                 # [B, H, hd]
    w1 = torch.exp(logw[:, 0])                             # decay in (0, 1)
    kv = shard_einsum("bhc,bhd->bhcd", k1, v1)
    y = shard_einsum("bhc,bhcd->bhd", r1, S + p.u[..., None] * kv)
    S = S * w1[..., None] + kv
    y = merge_dims(y, 1, 2)[:, None].to(x.dtype)
    y = rms_norm(y, p.ln_x, cfg.norm_eps) * g
    out = as_layout(y @ p.wo, x)        # a DTensor's partial sums reduced

    h = x + out
    cm = _channel_mix(p, h, last_h)
    return out + cm, (x[:, -1, :], S, h[:, -1, :])
