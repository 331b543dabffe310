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
parallelism does; :func:`align` gives a scan's operands one layout;
:func:`relayout` redistributes with a gradient every torch version can
make; :func:`shard_einsum` and :func:`per_shard` run on each rank's
shards (through :func:`run_local`), and :func:`on_replicas` runs indexed
reads and writes on whole replicas.  These keep off what not every torch
version's ``DTensor`` can do: flatten a shard that is not the leading dim
of the flattened group, ``index_put``, and the gradients of cumsum (a
flip) and softplus.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import torch

__all__ = ["set_specs", "activation_specs", "unrolled_scans", "scan_unroll",
           "constrain", "replicate_like", "is_dtensor", "split_dim",
           "merge_dims", "gather_rows", "as_layout", "align", "settle",
           "relayout", "recorded_fallbacks", "shard_einsum",
           "einsum_needs_shards", "per_shard", "run_local", "on_replicas"]

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


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def _stride_like(local, shape) -> tuple:
    """The strides of a tensor of ``shape`` laid out in memory in the dim
    order of ``local`` (an einsum's result is often a permuted view)."""
    order = sorted(range(local.ndim), key=lambda i: -local.stride(i))
    stride, n = [0] * len(shape), 1
    for i in reversed(order):
        stride[i] = n
        n *= shape[i]
    return tuple(stride)


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
    return DTensor.from_local(merged, x.device_mesh, x.placements,
                              shape=shape, stride=_contiguous(shape),
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


class _LayoutGrad(torch.autograd.Function):
    """A local shard as it is; its gradient comes back in the shard's own
    memory layout, which the ``DTensor`` it came from declares (a local
    product's gradient is often a permuted view, on which DTensor's views
    fail)."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.shape, x.stride())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.new_empty_strided(*ctx.layout).copy_(g)


def _shard_plan(eq: str, ops):
    """The per-shard plan of ``einsum(eq, *ops)`` over ``DTensor``
    operands, or None where there is none.  Per mesh dim one label is
    sharded: the label the largest operand shards there, else, where
    operands hold partial sums, the first output label they all have.
    Each operand with that label is laid out sharded on it (a replica
    slices its own shard, partial sums are reduce-scattered, another shard
    moves), every other one as a replica.  The output is sharded on the
    label, or holds partial sums where the label is contracted (only
    where no gradient is recorded).  Returns (input labels, output labels,
    label -> global size, per-operand placements, output placements)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if "..." in eq or "->" not in eq:
        return None
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    if len(ins) != len(ops) or not all(is_dtensor(t) for t in ops):
        return None
    mesh = ops[0].device_mesh
    if any(t.device_mesh != mesh for t in ops):
        return None
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in ops)
    sizes = {}
    for lab, t in zip(ins, ops):
        sizes.update(zip(lab, t.shape))
    want = [list(t.placements) for t in ops]
    out_pl = []
    for i in range(mesh.ndim):
        shards = [(t.numel(), lab[t.placements[i].dim % len(lab)])
                  for lab, t in zip(ins, ops) if t.placements[i].is_shard()]
        part = [lab for lab, t in zip(ins, ops)
                if t.placements[i].is_partial()]
        L = max(shards)[1] if shards else None
        if L is None and part:
            L = next((c for c in out if all(c in lab for lab in part)), None)
            if L is None:
                return None
        if L is None:
            out_pl.append(Replicate())
        elif L in out:
            out_pl.append(Shard(out.index(L)))
        elif grad:
            return None
        else:
            out_pl.append(Partial())
        for j, lab in enumerate(ins):
            want[j][i] = (Replicate() if L is None or L not in lab
                          else Shard(lab.index(L)))
    return ins, out, sizes, want, out_pl


def einsum_needs_shards(eq: str, *ops) -> bool:
    """Whether torch's own ``einsum(eq, *ops)`` would flatten a shard that
    is not the leading dim of its group, where :func:`shard_einsum` has a
    plan.  Torch flattens each group of labels (those the output and
    several operands have, each operand's own output labels, the
    contracted ones) into one dim, which not every torch version can do
    with a shard on any but the group's first label."""
    plan = _shard_plan(eq, ops)
    if plan is None:
        return False
    ins, out, _, _, out_pl = plan
    sharded = {lab[p.dim % len(lab)] for lab, t in zip(ins, ops)
               for p in t.placements if p.is_shard()}
    sharded |= {out[p.dim] for p in out_pl if p.is_shard()}
    groups = [[c for c in out if sum(c in lab for lab in ins) > 1]]
    groups += [[c for c in out if c in lab and
                sum(c in m for m in ins) == 1] for lab in ins]
    groups.append([c for c in dict.fromkeys("".join(ins))
                   if c not in out and sum(c in lab for lab in ins) > 1])
    return any(set(g[1:]) & sharded for g in groups)


def shard_einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)``; over ``DTensor`` operands for which
    :func:`_shard_plan` has a layout (one sharded label a mesh dim), the
    einsum of each rank's local shards: the operands are laid out as the
    plan says first (nothing moves where they already are), and the result
    is sharded on the plan's labels (partial sums where one is
    contracted).  Torch's own einsum flattens groups of labels into one
    dim, which not every torch version can do with a shard that does not
    lead its group (:func:`einsum_needs_shards`).  An operand without a
    mesh dim's label is a replica there, and its gradient comes back as
    partial sums.  Plain tensors, and any other layout, take torch's
    einsum."""
    plan = _shard_plan(eq, ops)
    if plan is None:
        return torch.einsum(eq, *ops)
    ins, out, sizes, want, out_pl = plan
    return run_local(lambda *locs: torch.einsum(eq, *locs), ops, want,
                     out_pl, tuple(sizes[c] for c in out))


def run_local(fn, ts, want, out_pl, shape):
    """``fn`` over each rank's local shards of the ``DTensor``s ``ts``,
    each first laid out as its entry of ``want`` says (nothing moves where
    it already is), the result of global ``shape`` placed as ``out_pl``
    (a tuple of results: ``shape`` and ``out_pl`` per result).  Gradients:
    an operand that is a replica where the result is not comes back as
    partial sums there, one that held partial sums as a replica."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..distributed.comm import redistribute

    many = isinstance(shape[0], (tuple, torch.Size))
    shapes, pls = (shape, out_pl) if many else ((shape,), (out_pl,))
    locs = []
    for t, pl in zip(ts, want):
        if tuple(pl) != t.placements:
            t = redistribute(t, pl)
        grad = [Replicate() if p.is_partial() else
                Partial() if (p.is_replicate() and
                              any(not o[i].is_replicate() for o in pls))
                else p for i, p in enumerate(pl)]
        locs.append(_LayoutGrad.apply(t.to_local(grad_placements=grad)))
    res = fn(*locs)
    res = res if many else (res,)
    mesh = ts[0].device_mesh
    out = tuple(DTensor.from_local(r, mesh, pl, shape=torch.Size(sh),
                                   stride=_stride_like(r, sh),
                                   run_check=False)
                for r, sh, pl in zip(res, shapes, pls))
    return out if many else out[0]


def per_shard(fn, x, whole: int | None = None):
    """``fn(x)`` for an ``fn`` that works row by row along every dim but
    ``whole`` (elementwise where ``whole`` is None); a ``DTensor`` with no
    shard on ``whole`` and no partial sums runs ``fn`` on each rank's shard
    and keeps its layout.  For what not every torch version's ``DTensor``
    has a strategy for: cumsum's gradient (a flip), softplus's gradient."""
    if not is_dtensor(x) or any(
            p.is_partial() or (whole is not None and p.is_shard() and
                               p.dim % x.ndim == whole % x.ndim)
            for p in x.placements):
        return fn(x)
    return run_local(fn, (x,), (x.placements,), x.placements, tuple(x.shape))


def on_replicas(fn, *ts):
    """``fn(*ts)``; where ``ts`` holds ``DTensor``s, each is made a replica
    on every rank (gathered once where it was not one), ``fn`` runs on the
    local copies and its result (a tensor or a tuple of them), the same on
    every rank, is a replica.  For indexed reads and writes (``buf[slot] =
    x[tok]``): not every torch version has a ``DTensor`` strategy for
    ``index_put``."""
    if not any(is_dtensor(t) for t in ts):
        return fn(*ts)
    from torch.distributed.tensor import DTensor, Replicate

    from ..distributed.comm import redistribute

    mesh = next(t for t in ts if is_dtensor(t)).device_mesh
    rep = [Replicate()] * mesh.ndim
    locs = [_LayoutGrad.apply((t if tuple(t.placements) == tuple(rep) else
                               redistribute(t, rep)).to_local())
            if is_dtensor(t) else t for t in ts]
    res = fn(*locs)

    def replica(r):
        return DTensor.from_local(r, mesh, rep, run_check=False)

    return tuple(map(replica, res)) if isinstance(res, tuple) else replica(res)


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
