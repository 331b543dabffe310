"""Mamba2 / SSD block (arXiv:2405.21060).

The port of ``repro.models.mamba2``.  State-space recurrence per head h
with scalar decay:

    S_t = a_t * S_{t-1} + (dt_t x_t) (x) B_t          S in R^{hd x state}
    y_t = C_t . S_t + D * x_t,   a_t = exp(-exp(A) dt_t)

Prefill uses the chunked (SSD) form: within a chunk of length L the
recurrence unrolls into causal matmuls via cumulative log-decays, and the
state is carried across chunks by a loop.  Decode is the single-step
recurrence.  In bf16 the intra-chunk transition ``M`` is formed in bf16 and
multiplied with float32 accumulation (both operands upcast, exact), as the
reference's ``preferred_element_type`` product does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import normal_, rms_norm
from .partitioning import (is_dtensor, merge_dims, replicate_like, run_local,
                           per_shard, settle, shard_einsum, split_dim)

__all__ = ["Mamba2", "mamba2_block", "mamba2_decode", "init_mamba2_state"]

# the reference's chunk length (its choice is a TPU memory trade-off; the
# port keeps it so that chunk boundaries, and the T % L rule, are the same)
CHUNK = 128


class Mamba2(nn.Module):
    """``init_mamba2``: ``in_proj`` (z, x, B, C, dt), the depthwise
    ``conv_w``, float32 ``A_log``/``D``/``dt_bias``, the gate ``norm`` and
    ``out_proj``."""

    def __init__(self, cfg, dtype, device, gen=None):
        super().__init__()
        d, din = cfg.d_model, cfg.d_inner
        H = cfg.ssm_heads
        st = cfg.ssm_state
        si = 1.0 / math.sqrt(d)
        f32 = torch.float32
        self.in_proj = nn.Parameter(normal_(gen, (d, 2 * din + 2 * st + H),
                                            si, dtype, device))
        self.conv_w = nn.Parameter(normal_(gen, (cfg.ssm_conv, din),
                                           1.0 / math.sqrt(cfg.ssm_conv),
                                           dtype, device))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, float(max(2, H)), H, dtype=f32, device=device)))
        self.D = nn.Parameter(torch.ones(H, dtype=f32, device=device))
        self.dt_bias = nn.Parameter(torch.zeros(H, dtype=f32, device=device))
        self.norm = nn.Parameter(torch.zeros(din, dtype=dtype, device=device))
        self.out_proj = nn.Parameter(normal_(gen, (din, d),
                                             1.0 / math.sqrt(din), dtype,
                                             device))


def _split_proj(p: Mamba2, u, cfg):
    din, st = cfg.d_inner, cfg.ssm_state
    z, x, Bm, Cm, dt = torch.split(u @ p.in_proj,
                                   [din, din, st, st, cfg.ssm_heads], dim=-1)
    dt = per_shard(F.softplus, dt.float() + p.dt_bias)
    return z, x, Bm, Cm, dt


def _causal_conv(x, w, state=None):
    """Depthwise causal conv; x [B, T, din], w [K, din].
    With ``state`` [B, K-1, din] performs the incremental step (the
    concatenation promotes to the wider of the two types, as the
    reference's does).  Without it, ``DTensor`` operands run on each
    rank's shards (:func:`_conv_layout`)."""
    K = w.shape[0]
    if state is not None:
        xa = torch.cat([state, x], dim=1)                  # [B, K-1+T, din]
        new_state = xa[:, -(K - 1):, :] if K > 1 else state
        out = _taps(xa, w, x.shape[1])
    else:
        lay = _conv_layout(x, w)
        if lay is None:
            out, new_state = _pad_taps(x, w)
        else:
            B, T, din = x.shape
            out, new_state = run_local(
                _pad_taps, (x, w), lay[:2], (lay[2], lay[2]),
                ((B, T, din), (B, K - 1, din)))
        if K == 1:
            new_state = None
    return F.silu(out), new_state


def _taps(xa, w, T):
    """The conv's taps: ``sum_i xa[:, i:i+T] * w[i]``, in tap order."""
    out = xa[:, 0:T, :] * w[0]
    for i in range(1, w.shape[0]):
        out = out + xa[:, i:i + T, :] * w[i]
    return out


def _pad_taps(x, w):
    """(taps over ``x`` zero-padded by K-1 rows in front, the last K-1 rows
    of the padded ``x``: the incremental step's state)."""
    K = w.shape[0]
    xa = F.pad(x, (0, 0, K - 1, 0))
    return _taps(xa, w, x.shape[1]), xa[:, xa.shape[1] - (K - 1):, :]


def _conv_layout(x, w):
    """For ``DTensor`` operands of the conv, (x's layout, w's layout, the
    output's): each mesh dim shards the channels of both, or keeps x's
    batch shard or partial sums against a replica of w; None where the
    sequence is sharded or the shards cross (then DTensor runs it, which
    not every torch version can: its pad and the taps' broadcast of a
    channel shard fail in some)."""
    if not (is_dtensor(x) and is_dtensor(w)):
        return None
    from torch.distributed.tensor import Replicate, Shard

    xl, wl = [], []
    for xp, wp in zip(x.placements, w.placements):
        x_dim = xp.dim % 3 if xp.is_shard() else None
        w_dim = wp.dim % 2 if wp.is_shard() else None
        if wp.is_partial() or w_dim == 0 or x_dim == 1:
            return None         # partial or split taps, a split sequence
        if w_dim == 1 or x_dim == 2:            # the channels split here
            if x_dim == 0:
                return None     # ... and the batch on the same mesh dim
            xl.append(Shard(2))
            wl.append(Shard(1))
        else:
            xl.append(xp)
            wl.append(Replicate())
    return xl, wl, xl


def _ssd_chunked(xh, Bm, Cm, dt, A_log, S0):
    """Chunked SSD scan.

    xh [B, T, H, hd]; Bm/Cm [B, T, st]; dt [B, T, H]; S0 [B, H, hd, st].
    Returns (y [B, T, H, hd], S_final)."""
    Bsz, T, H, hd = xh.shape
    L = min(CHUNK, T)
    assert T % L == 0, (T, L)
    nC = T // L

    loga = (-torch.exp(A_log)[None, :, None] *
            dt.transpose(1, 2).float())                     # [B, H, T]
    u = xh * dt[..., None].to(xh.dtype)                     # dt-weighted
    m_dtype = xh.dtype if xh.dtype == torch.bfloat16 else torch.float32
    causal = replicate_like(torch.tril(torch.ones((L, L), dtype=torch.bool,
                                                  device=xh.device)), xh)

    S = S0.float()
    # the operands' partial sums reduced once, not chunk by chunk
    u, Bm, Cm, loga, S = settle(u, Bm, Cm, loga, S)
    ys = []
    for c in range(nC):
        sl = slice(c * L, (c + 1) * L)
        u_c, B_c, C_c, la_c = u[:, sl], Bm[:, sl], Cm[:, sl], loga[..., sl]
        l = per_shard(lambda t: torch.cumsum(t, dim=-1), la_c, -1)  # [B,H,L]
        # intra-chunk: M[t, j] = (C_t . B_j) exp(l_t - l_j), j <= t.  The
        # exponent is masked before the exp: above the diagonal l_t - l_j
        # > 0 grows with the chunk's decays, and an exp that overflows
        # there turns the masked product's gradient into 0 * inf = NaN
        # (the reference's does, past float32's range); the values kept
        # are the same
        cb = shard_einsum("bts,bjs->btj", C_c.float(), B_c.float())
        dec = torch.exp(torch.where(causal, l[..., :, None] - l[..., None, :],
                                    -math.inf))             # [B, H, L, L]
        M = torch.where(causal, cb[:, None] * dec, 0.0).to(m_dtype)
        y = shard_einsum("bhtj,bjhp->bthp", M.float(),
                         u_c.to(m_dtype).float())
        # inter-chunk: y_t += exp(l_t) * (S0 @ C_t)
        y = y + shard_einsum("bht,bhps,bts->bthp", torch.exp(l), S,
                             C_c.float())
        # state update: S' = exp(l_L) S + sum_j exp(l_L - l_j) u_j (x) B_j
        w = torch.exp(l[..., -1:] - l)                      # [B, H, L]
        S = (S * torch.exp(l[..., -1])[..., None, None] +
             shard_einsum("bhj,bjhp,bjs->bhps", w, u_c.float(), B_c.float()))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    return y.to(xh.dtype), S


def mamba2_block(p: Mamba2, u: torch.Tensor, cfg, state=None,
                 conv_state=None):
    """Full-sequence Mamba2 block. u [B, T, d] -> (y, (S, conv_state))."""
    B, T, d = u.shape
    H, st = cfg.ssm_heads, cfg.ssm_state
    hd = cfg.d_inner // H
    z, x, Bm, Cm, dt = _split_proj(p, u, cfg)
    x, conv_state = _causal_conv(x, p.conv_w, conv_state)
    xh = split_dim(x, -1, (H, hd))
    S0 = (replicate_like(torch.zeros((B, H, hd, st), dtype=torch.float32,
                                     device=u.device), u)
          if state is None else state)
    y, S = _ssd_chunked(xh, Bm, Cm, dt, p.A_log, S0)
    y = y + xh.float() * p.D[None, None, :, None]
    y = merge_dims(y, 2, 3).to(u.dtype)
    y = rms_norm(y, p.norm, cfg.norm_eps) * F.silu(z)
    return y @ p.out_proj, (S, conv_state)


def init_mamba2_state(cfg, batch: int, device=None):
    H, st = cfg.ssm_heads, cfg.ssm_state
    hd = cfg.d_inner // H
    f32 = torch.float32
    return (torch.zeros((batch, H, hd, st), dtype=f32, device=device),
            torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=f32,
                        device=device))


def mamba2_decode(p: Mamba2, u: torch.Tensor, cfg, state, conv_state):
    """Single-step recurrence. u [B, 1, d]."""
    B, _, d = u.shape
    H = cfg.ssm_heads
    hd = cfg.d_inner // H
    z, x, Bm, Cm, dt = _split_proj(p, u, cfg)
    x, conv_state = _causal_conv(x, p.conv_w, conv_state.to(x.dtype))
    xh = split_dim(x, -1, (H, hd))[:, 0]
    dt1 = dt[:, 0]                                          # [B, H]
    a = torch.exp(-torch.exp(p.A_log)[None] * dt1)          # [B, H]
    upd = shard_einsum("bhp,bs->bhps", xh.float() * dt1[..., None],
                       Bm[:, 0].float())
    S = state * a[..., None, None] + upd
    y = shard_einsum("bhps,bs->bhp", S, Cm[:, 0].float())
    y = y + xh.float() * p.D[None, :, None]
    y = merge_dims(y, 1, 2)[:, None].to(u.dtype)
    y = rms_norm(y, p.norm, cfg.norm_eps) * F.silu(z)
    return y @ p.out_proj, (S, conv_state)
