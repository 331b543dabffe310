"""Activation-partitioning hooks: the port of ``repro.models.partitioning``.

Launchers set a spec for the residual stream, the logits and the attention
operands; the model applies them through :func:`constrain` at the
reference's call sites (layer-group boundaries, attention, the cross
entropy's logits).  A spec is a tuple with one entry per tensor dim:
``None``, a mesh axis name, or a tuple of axis names (a ``PartitionSpec``
as a tuple).  ``constrain`` is the counterpart of
``with_sharding_constraint``: it redistributes a ``DTensor`` to the spec's
placements on its own mesh, and returns a plain tensor, or any tensor when
the spec is unset, as it is (so on one card every call is a no-op).

With ``("pod", "data"), "model", None`` on the residual stream the
activations shard their sequence axis over the model axis: Megatron-style
sequence parallelism.  The port has no ``lax.scan``; :func:`scan_unroll`
carries the reference's flag for the lowering proofs, which read it.

The rest makes a model whose inputs and parameters are ``DTensor``s
trace without ``implicit_replication()``, and every one of them returns a
plain tensor's result unchanged: :func:`replicate_like` puts a tensor a
forward builds from shapes and constants (positions, masks, zeros) in the
activations' layout; :func:`split_dim` splits heads out of a projection
where DTensor keeps no uneven shard, noting each such departure from
GSPMD's layout for :func:`recorded_fallbacks`, and :func:`merge_dims`
merges them back; :func:`gather_rows` gathers a sequence-sharded
activation before a projection and :func:`as_layout` puts a projection's
output back on the residual stream's shards, as Megatron's sequence
parallelism does; :func:`align` gives a scan's operands one layout; and
:func:`relayout` redistributes with a gradient every torch version can
make.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

__all__ = ["set_specs", "activation_specs", "unrolled_scans", "scan_unroll",
           "constrain", "replicate_like", "is_dtensor", "split_dim",
           "merge_dims", "gather_rows", "as_layout", "align", "settle",
           "relayout", "recorded_fallbacks"]

_KEYS = ("act", "logits", "attn_q", "attn_kv", "attn_out", "attn_chunk",
         "attn_chunks")
_SPECS: dict[str, object] = {k: None for k in _KEYS}
_SPECS["unroll"] = False
_FALLBACKS: list[set] = []      # the open recorded_fallbacks() blocks


def set_specs(**kw) -> None:
    """Set every key's spec (a key not given is unset)."""
    for k in _KEYS:
        _SPECS[k] = kw.get(k)


@contextmanager
def activation_specs(**kw):
    """The specs of ``kw`` inside the block; the previous ones after it."""
    old = dict(_SPECS)
    set_specs(**kw)
    try:
        yield
    finally:
        _SPECS.update(old)


@contextmanager
def unrolled_scans(on: bool = True):
    """The reference unrolls every ``lax.scan`` inside this block for its
    roofline cost pass; the port only carries the flag."""
    old = _SPECS["unroll"]
    _SPECS["unroll"] = on
    try:
        yield
    finally:
        _SPECS["unroll"] = old


def scan_unroll() -> bool:
    return bool(_SPECS["unroll"])


def constrain(x, which: str):
    """``x`` laid out as the spec of ``which`` says: a ``DTensor`` is
    redistributed to the spec's placements on its mesh; a plain tensor, or
    any tensor while the spec is unset, comes back as it is."""
    spec = _SPECS.get(which)
    if spec is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from ..distributed.comm import redistribute
    from ..distributed.sharding import placements_for

    return redistribute(x, placements_for(spec, x.device_mesh))


def replicate_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor built from nothing but shapes and constants, as
    ``ref`` is held: a ``DTensor`` replicated over ``ref``'s mesh when
    ``ref`` is a ``DTensor`` (every rank builds the same ``t``, so nothing
    is sent), else ``t`` itself."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(ref):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@contextmanager
def recorded_fallbacks():
    """A set that collects, inside the block, every note of
    :func:`split_dim` replicating a shard that GSPMD would have split."""
    notes: set = set()
    _FALLBACKS.append(notes)
    try:
        yield notes
    finally:
        _FALLBACKS.remove(notes)


def split_dim(x, dim: int, sizes: tuple):
    """``x`` with dimension ``dim`` split into ``sizes`` (a reshape).  A
    ``DTensor`` sharded on ``dim`` over mesh dims whose shard count does
    not divide ``sizes[0]`` (heads fewer than the model axis) is first
    replicated over them: GSPMD splits such a shard across the new dims,
    DTensor keeps no uneven shard."""
    dim = dim % x.ndim
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if not is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    over = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    n = 1
    for i in over:
        n *= mesh.size(i)
    if over and sizes[0] % n:
        from ..distributed.comm import redistribute

        names = tuple(mesh.mesh_dim_names[i] for i in over)
        for notes in _FALLBACKS:
            notes.add(f"{tuple(x.shape)} dim {dim} -> {tuple(sizes)}: "
                      f"{sizes[0]} % {n} ({'x'.join(names)}) != 0, "
                      "replicated")
        x = redistribute(x, [Replicate() if i in over else p
                             for i, p in enumerate(x.placements)])
    return x.reshape(shape)


def merge_dims(x, start: int, end: int):
    """``x`` with dimensions ``start..end`` merged into one (a reshape; the
    inverse of :func:`split_dim`).  A ``DTensor`` sharded on none of them
    but the first is merged shard by shard and keeps its placements: its
    gradient, in whatever layout it comes back, is redistributed to them
    before the split back, where DTensor's own view would split the
    gradient's shard unevenly (fewer heads than the model axis)."""
    start, end = start % x.ndim, end % x.ndim
    shape = (*x.shape[:start], math.prod(x.shape[start:end + 1]),
             *x.shape[end + 1:])
    if not is_dtensor(x) or any(
            p.is_shard() and start < p.dim <= end for p in x.placements):
        return x.reshape(shape)
    from torch.distributed.tensor import DTensor

    local = x.to_local()
    merged = local.reshape(*local.shape[:start], -1, *local.shape[end + 1:])
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(merged, x.device_mesh, x.placements,
                              shape=shape, stride=tuple(stride),
                              run_check=False)


def gather_rows(x):
    """``x`` as a projection takes it: a ``DTensor`` sharded on a dim
    between its first and its last (the sequence, under sequence
    parallelism) is first gathered over it, as Megatron's sequence
    parallelism gathers before a column-parallel projection (and because
    DTensor's matmul flattens the leading dims, which not every torch
    version does with a sharded middle dim).  Anything else comes back as
    it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    middle = [i for i, p in enumerate(x.placements)
              if p.is_shard() and 0 < p.dim % x.ndim < x.ndim - 1]
    if not middle:
        return x
    from ..distributed.comm import redistribute

    return redistribute(x, [Replicate() if i in middle else p
                            for i, p in enumerate(x.placements)])


class _Relayout(torch.autograd.Function):
    """A ``DTensor`` redistributed; its gradient goes back in the input's
    layout with every partial placement replicated (DTensor's own backward
    asks for the partial layout itself, which not every torch version can
    make from a shard)."""

    @staticmethod
    def forward(ctx, x, placements):
        from torch.distributed.tensor import Replicate

        from ..distributed.comm import redistribute

        ctx.back = tuple(Replicate() if p.is_partial() else p
                         for p in x.placements)
        if tuple(placements) == x.placements:
            return x.view_as(x)
        return redistribute(x, placements)

    @staticmethod
    def backward(ctx, g):
        from ..distributed.comm import redistribute

        if g.placements != ctx.back:
            g = redistribute(g, ctx.back)
        return g, None


def relayout(x, placements):
    """The ``DTensor`` ``x`` in ``placements`` (see :class:`_Relayout`)."""
    return _Relayout.apply(x, list(placements))


def as_layout(y, x):
    """``y`` in ``x``'s layout when both are ``DTensor``s (a row-parallel
    projection's partial sums reduce-scattered onto the residual stream's
    sequence shards, as Megatron's sequence parallelism does; in the
    backward the gradient is gathered back); else ``y`` as it is."""
    if not (is_dtensor(y) and is_dtensor(x)) or y.placements == x.placements:
        return y
    return relayout(y, x.placements)


def align(*ts):
    """``ts``, ``DTensor``s of one shape, in one layout: the first's with
    its partial sums reduced (so that a loop over their slices moves no
    shard slice by slice); plain tensors as they are."""
    if not is_dtensor(ts[0]):
        return ts
    from torch.distributed.tensor import Replicate

    lay = tuple(Replicate() if p.is_partial() else p
                for p in ts[0].placements)
    return tuple(t if t.placements == lay else relayout(t, lay) for t in ts)


def settle(*ts):
    """``ts`` with every ``DTensor``'s partial sums reduced (a replica
    where it was partial; its shards kept), so that a loop over their
    slices reduces nothing slice by slice; plain tensors as they are."""
    from torch.distributed.tensor import Replicate

    return tuple(
        relayout(t, [Replicate() if p.is_partial() else p
                     for p in t.placements])
        if is_dtensor(t) and any(p.is_partial() for p in t.placements)
        else t for t in ts)
