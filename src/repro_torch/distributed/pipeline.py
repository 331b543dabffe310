"""GPipe-style pipeline parallelism over the ranks of a process group: the
port of ``repro.distributed.pipeline``.

Each rank is a stage and runs its ``[L / n_stages]`` slice of the layer
stack; micro-batches stream through the stages in a classic GPipe schedule
of ``n_micro + n_stages - 1`` ticks, a ring shift (the reference's
``ppermute``) carrying each tick's activations to the next stage, and a
closing ``all_reduce(SUM)`` (its ``psum``) giving every rank the last
stage's output.  Numerically it is the full stack run in order on each
micro-batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .comm import all_reduce, ring_shift

__all__ = ["pipelined_apply", "sequential_apply"]


def _layer(stacked, i):
    if isinstance(stacked, dict):
        return {k: v[i] for k, v in stacked.items()}
    return stacked[i]


def _n_layers(stacked) -> int:
    if isinstance(stacked, dict):
        return next(iter(stacked.values())).shape[0]
    return stacked.shape[0]


def sequential_apply(layer_fn, stacked_params, x):
    """Reference: apply all L stacked layers in order.  ``stacked_params``:
    a tensor or a dict of tensors with a leading layer axis; x [B, ...]."""
    h = x
    for i in range(_n_layers(stacked_params)):
        h = layer_fn(_layer(stacked_params, i), h)
    return h


def pipelined_apply(layer_fn, stacked_params, x, *, group=None,
                    n_micro: int):
    """GPipe forward over the ranks of ``group`` (stage = rank).

    ``stacked_params``: the whole stack, leading layer axis ``L = n_stages
    * per_stage`` (each rank takes its stage's slice, as the reference's
    ``shard_map`` does); ``x``: ``[B, ...]`` with ``B % n_micro == 0``,
    the same on every rank.  Returns the stack's output ``[B, ...]`` on
    every rank."""
    n_stages = dist.get_world_size(group)
    sid = dist.get_rank(group)
    L = _n_layers(stacked_params)
    if L % n_stages:
        raise ValueError(f"{L} layers over {n_stages} stages")
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} over {n_micro} micro-batches")
    mb = B // n_micro
    per = L // n_stages
    mine = (({k: v[sid * per:(sid + 1) * per]
              for k, v in stacked_params.items()})
            if isinstance(stacked_params, dict)
            else stacked_params[sid * per:(sid + 1) * per])
    out = torch.zeros_like(x)
    carry = torch.zeros((mb, *x.shape[1:]), dtype=x.dtype, device=x.device)
    for t in range(n_micro + n_stages - 1):
        # stage 0 takes micro-batch t (clipped), the others their carry
        i = min(t, n_micro - 1)
        h = x[i * mb:(i + 1) * mb] if sid == 0 else carry
        h = sequential_apply(layer_fn, mine, h)
        # the last stage emits micro-batch t - n_stages + 1
        if sid == n_stages - 1 and t >= n_stages - 1:
            j = t - (n_stages - 1)
            out[j * mb:(j + 1) * mb] = h
        carry = ring_shift(h, group)
    # only the last stage holds results; the others contribute zeros
    return all_reduce(out, dist.ReduceOp.SUM, group)
