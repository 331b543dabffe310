"""Mixture-of-Experts block: top-k routing with capacity-based dispatch
(GShard-style).

The port of ``repro.models.moe``.  Dispatch is computed per sequence
(token groups of size S) at prefill; decode (S = 1) dispatches over the
batch axis instead.  Expert compute is a dense [E, C, d] x [E, d, ff]
einsum — FLOPs proportional to *active* parameters (capacity-bounded).

Two deliberate choices keep the results deterministic on the card: each
kept slot of the dispatch buffer receives at most one token, so the
buffer is filled by an indexed copy; and each token's ``top_k`` weighted
expert outputs are added in slot order in the storage type (the order of
the reference's scatter-add), not with atomics.  ``torch.topk`` does not
promise the reference's lower-index-first order among tied router
probabilities; random float32 logits make ties rare.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, mlp_block, normal_
from .partitioning import on_replicas

__all__ = ["MoE", "moe_block"]


class MoE(nn.Module):
    """``init_moe``: a float32 ``router [d, E]``, expert weights
    ``w_gate``/``w_up [E, d, ff]``, ``w_down [E, ff, d]``, and a gated
    ``shared`` MLP where the config has shared experts."""

    def __init__(self, cfg, dtype, device, gen=None):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
        self.router = nn.Parameter(normal_(gen, (d, E), si, torch.float32,
                                           device))
        self.w_gate = nn.Parameter(normal_(gen, (E, d, ff), si, dtype, device))
        self.w_up = nn.Parameter(normal_(gen, (E, d, ff), si, dtype, device))
        self.w_down = nn.Parameter(normal_(gen, (E, ff, d), so, dtype, device))
        if cfg.n_shared_experts:
            self.shared = MLP(d, ff * cfg.n_shared_experts, True, dtype,
                              device, gen)


def _fill(x, slot, k: int, E: int, cap: int):
    """The dispatch buffer [E, cap, d]: token ``i // k`` of ``x`` [N, d] at
    row ``slot[i]``.  One token per kept slot; every dropped token lands on
    an overflow row past the last, which is cut off (shapes stay static: no
    boolean indexing)."""
    N, d = x.shape
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x[tok]
    return buf[:-1].reshape(E, cap, d)


def _combine(out, slot, keep, w):
    """y [N, d]: each token's ``top_k`` expert outputs of ``out`` [E, cap,
    d] (zero where dropped), weighted by ``w`` [N, k] and added in slot
    order in the storage type."""
    E, cap, d = out.shape
    N, k = w.shape
    gathered = out.reshape(E * cap, d)
    y_slots = torch.where(keep[:, None],
                          gathered[torch.clamp(slot, 0, E * cap - 1)],
                          torch.zeros((), dtype=out.dtype, device=out.device))
    y_slots = (y_slots * w.reshape(N * k, 1).to(out.dtype)).reshape(N, k, d)
    y = y_slots[:, 0]
    for j in range(1, k):                         # slot order, storage type
        y = y + y_slots[:, j]
    return y


def _route(logits, k: int, cap: int):
    """Top-``k`` routing of ``logits`` [N, E] with capacity ``cap`` per
    expert: the renormalised weights ``w`` [N, k], each slot's buffer row
    ``slot`` [N*k] (the overflow row ``E * cap`` where dropped), ``keep``
    [N*k], and the load-balancing auxiliary loss (Switch: E * sum_e f_e *
    P_e)."""
    N, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k)                               # [N, k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(idx, E).float()                          # [N, k, E]
    flat = onehot.reshape(N * k, E)                             # slot-major
    pos = torch.cumsum(flat, dim=0) - flat                      # per expert
    pos = (pos * flat).sum(-1).to(torch.int64)                  # [N*k]
    e_flat = idx.reshape(N * k)
    keep = (pos < cap) & (w.reshape(N * k) > 0)
    slot = torch.where(keep, e_flat * cap + pos,
                       torch.full_like(pos, E * cap))           # overflow row

    f = onehot.sum(dim=(0, 1)) / max(1, N)                      # fraction
    P = probs.mean(dim=0)
    aux = E * torch.sum(f * P)
    return w, slot, keep, aux


def _dispatch_group(p: MoE, x: torch.Tensor, cfg):
    """x [N, d] one dispatch group; returns (y [N, d], aux_loss scalar).
    The router's and the experts' products run on the operands as they
    are held; the routing, the buffer's indexed write and the outputs'
    indexed read run on whole replicas (every rank the same), so a
    ``DTensor`` needs no ``index_put`` strategy."""
    N, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(math.ceil(N * k * cfg.capacity_factor / E)))

    logits = x.float() @ p.router                               # [N, E]
    w, slot, keep, aux = on_replicas(partial(_route, k=k, cap=cap), logits)
    buf = on_replicas(partial(_fill, k=k, E=E, cap=cap), x, slot)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p.w_gate))
    h = h * torch.einsum("ecd,edf->ecf", buf, p.w_up)
    out = torch.einsum("ecf,efd->ecd", h, p.w_down)             # [E, cap, d]

    y = on_replicas(_combine, out, slot, keep, w)
    return y, aux


def moe_block(p: MoE, x: torch.Tensor, cfg):
    """x [B, S, d] -> (y [B, S, d], aux loss scalar)."""
    B, S, d = x.shape
    if S == 1:
        y, aux = _dispatch_group(p, x[:, 0, :], cfg)
        y = y[:, None, :]
    else:
        outs = [_dispatch_group(p, x[b], cfg) for b in range(B)]
        y = torch.stack([o[0] for o in outs])
        aux = torch.stack([o[1] for o in outs]).mean()
    if cfg.n_shared_experts:
        y = y + mlp_block(p.shared, x, cfg.act)
    return y, aux
