"""Sharding rules and the pane-batch sharding hook: the port of
``repro.distributed.sharding``.

Logical placement, as in the reference:
  * TP ("model"): attention heads / head_dim, FFN hidden, vocab, experts.
  * FSDP ("data"): the other matrix dimension of every large parameter.
  * DP: batch over ("pod", "data"); pods replicate parameters, so the
    gradient all-reduce crossing the pod links touches each parameter once
    (the hook for :mod:`~repro_torch.distributed.compression`).
  * SP/CP: when the batch is smaller than the data axis, activations and
    KV caches shard their sequence axis over "data" instead.

A spec is a tuple with one entry per tensor dim: ``None``, a mesh axis
name, or a tuple of axis names (a ``PartitionSpec`` as a tuple).  The rules
read only a mesh's axis names and sizes: a ``DeviceMesh``, or anything
with ``axis_names`` and ``shape`` (a dict, or a tuple in axis order), so
the 256- and 512-chip production meshes can be checked without as many
ranks.  Every rule is divisibility-checked against the actual dimension; a
non-divisible axis falls back to replication for that dim (reported by
:func:`explain`).

The port's parameters are named as its ``LM`` names them (dotted,
``layers.<i>.attn.wq``) and are unstacked: the reference's scanned
``scan/<ci>/attn/wq`` of shape ``[G, ...]`` is layer ``g * len(cycle) +
ci``'s ``[...]``.  A port spec is the reference's with the leading group
``None`` dropped.  :func:`shardings_for` turns specs into
``(DeviceMesh, placements)`` pairs for ``distribute_tensor``.

The pane-batch hook (:func:`pane_bucket_shards`) splits one size bucket of
the engine's burst jobs into sub-batches, each launched on its own
(``HamletRuntime(..., shard_slices=lambda nb: pane_bucket_shards(nb,
n))``); :func:`shard_pane_bucket` places a stacked bucket on a mesh with
its batch axis split over the data-parallel axes.
"""

from __future__ import annotations

import math
import re

import numpy as np

__all__ = ["param_pspecs", "batch_pspecs", "cache_pspecs", "shardings_for",
           "placements_for", "mesh_axes", "explain", "pane_bucket_shards",
           "pane_batch_pspecs", "shard_pane_bucket"]

# (name regex, spec template): templates name logical axes per dim; the
# first match wins.  "tp" -> model, "fsdp" -> data, None -> replicate.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("tp", "fsdp")),
    (r"lm_head$", ("fsdp", "tp")),
    (r"(final_norm|ln\w*|.*norm|post_ln\d)$", (None,)),
    (r"attn\.w[qkv]$", ("fsdp", "tp")),
    (r"attn\.wo$", ("tp", "fsdp")),
    (r"(attn|cross)\.[qk]_norm$", (None,)),
    (r"cross\.w[qkv]$", ("fsdp", "tp")),
    (r"cross\.wo$", ("tp", "fsdp")),
    (r"mlp\.w_(gate|up)$", ("fsdp", "tp")),
    (r"mlp\.w_down$", ("tp", "fsdp")),
    (r"moe\.router$", ("fsdp", None)),
    (r"moe\.w_(gate|up)$", ("tp", "fsdp", None)),   # experts over model (EP)
    (r"moe\.w_down$", ("tp", None, "fsdp")),
    (r"moe\.shared\.w_(gate|up)$", ("fsdp", "tp")),
    (r"moe\.shared\.w_down$", ("tp", "fsdp")),
    (r"mamba\.in_proj$", ("fsdp", "tp")),
    (r"mamba\.out_proj$", ("tp", "fsdp")),
    (r"mamba\.conv_w$", (None, "tp")),
    (r"mamba\.(A_log|D|dt_bias)$", (None,)),
    (r"rwkv\.w[rkvgo]$", ("fsdp", "tp")),
    (r"rwkv\.w0$", (None,)),
    (r"rwkv\.w1$", ("fsdp", None)),
    (r"rwkv\.w2$", (None, "fsdp")),
    (r"rwkv\.u$", (None, None)),
    (r"rwkv\.mu$", (None, None)),
    (r"rwkv\.cmu$", (None, None)),
    (r"rwkv\.ck$", ("fsdp", "tp")),
    (r"rwkv\.cv$", ("tp", "fsdp")),
    (r"rwkv\.cr$", ("fsdp", "tp")),
    (r".*", (None,)),
]


def mesh_axes(mesh) -> dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    shape = mesh.shape
    if isinstance(shape, dict):
        return {n: int(shape[n]) for n in mesh.axis_names}
    return {n: int(s) for n, s in zip(mesh.axis_names, shape)}


def _axis_name(logical: str | None, axes: dict) -> str | None:
    if logical is None:
        return None
    if logical == "tp":
        return "model" if "model" in axes else None
    if logical == "fsdp":
        return "data" if "data" in axes else None
    raise ValueError(logical)


def _spec_for(name: str, shape: tuple[int, ...], axes: dict,
              notes: list | None = None) -> tuple:
    for pat, template in _PARAM_RULES:
        if re.search(pat, name):
            extra = len(shape) - len(template)
            dims: list[str | None] = [None] * max(0, extra) + list(template)
            dims = dims[: len(shape)]
            out = []
            for dim, logical in zip(shape, dims):
                ax = _axis_name(logical, axes)
                if ax is not None and dim % axes[ax] != 0:
                    if notes is not None:
                        notes.append((name, tuple(shape), logical,
                                      f"{dim} % {axes[ax]} != 0"))
                    ax = None
                out.append(ax)
            return tuple(out)
    return ()


def param_pspecs(params: dict, mesh, notes: list | None = None) -> dict:
    """Parameter name -> spec for ``params`` (name -> anything with a
    ``shape``: ``dict(model.named_parameters())`` of a model on the
    ``meta`` device allocates nothing); also for an optimizer state's
    moments, which are named as the parameters."""
    axes = mesh_axes(mesh)
    return {n: _spec_for(n, tuple(p.shape), axes, notes)
            for n, p in params.items()}


def _dp(axes: dict):
    """The data-parallel axes as one spec entry (a name, a tuple of names,
    or None, as a ``PartitionSpec`` normalizes them) and their size."""
    names = tuple(a for a in ("pod", "data") if a in axes)
    entry = names if len(names) > 1 else (names[0] if names else None)
    return entry, math.prod(axes[a] for a in names)


def batch_pspecs(batch: dict, mesh, *, global_batch: int) -> dict:
    """Input-batch specs: batch over (pod, data) when divisible, otherwise
    sequence over data (context parallelism)."""
    axes = mesh_axes(mesh)
    dp_axes, dp = _dp(axes)

    def f(name, shape):
        if name.endswith("positions"):          # [3, B, S]
            if global_batch % dp == 0:
                return (None, dp_axes, None)
            return (None, None, "data")
        if name.endswith("pos"):                # [B]
            if global_batch % dp == 0:
                return (dp_axes,)
            return (None,)
        if (len(shape) >= 2 and shape[0] == global_batch
                and global_batch % dp == 0):
            return (dp_axes, *([None] * (len(shape) - 1)))
        if len(shape) >= 2 and shape[1] % axes.get("data", 1) == 0:
            # batch too small: shard the sequence axis (CP)
            return (None, "data", *([None] * (len(shape) - 2)))
        return tuple([None] * len(shape))

    return {k: f(k, tuple(v.shape)) for k, v in batch.items()}


def _map_tree(f, tree, path=""):
    """``tree`` (dicts, lists, tuples of leaves) with each leaf replaced by
    ``f(path, leaf)``; ``path`` joins keys and indices with "/"."""
    if isinstance(tree, dict):
        return {k: _map_tree(f, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(f, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return f(path, tree)


def cache_pspecs(cache, mesh, *, batch: int):
    """Decode-state specs, in the structure of the port's cache (a list of
    per-layer dicts, ``init_cache``).  K/V caches ``[B, S, KV, hd]``: batch
    over (pod, data) when divisible, else sequence over data; the sequence
    axis over model (split-K decode: attention reduces over local KV slices
    and combines partial softmax statistics, the cache is never gathered).
    Recurrent states shard their batch axis, or their head axis over data
    when the batch is too small."""
    axes = mesh_axes(mesh)
    dp_axes, dp = _dp(axes)
    data = axes.get("data", 1)
    model = axes.get("model", 1)

    def f(p, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if p.endswith("pos"):                # ring positions [B, span]
            lead = [None] * (nd - 2)
            if batch % dp == 0:
                return (*lead, dp_axes, None)
            return (*lead, None, "data" if shape[-1] % data == 0 else None)
        if re.search(r"(^|/)(x?[kv])$", p) and nd >= 4:
            lead = [None] * (nd - 4)
            b, s, kv, hd = shape[-4:]
            if batch % dp == 0:
                s_ax = "model" if s % model == 0 else None
                return (*lead, dp_axes, s_ax, None, None)
            if s % (data * model) == 0:
                return (*lead, None, ("data", "model"), None, None)
            s_ax = "data" if s % data == 0 else None
            return (*lead, None, s_ax, None, None)
        if "mamba_state" in p or "rwkv_state" in p:
            lead: list = [None] * nd
            # the batch axis: the first dim equal to the batch
            for i, d in enumerate(shape):
                if d == batch and batch % dp == 0:
                    lead[i] = dp_axes
                    break
            else:
                # the batch is too small: shard the head axis over data
                for i, d in enumerate(shape):
                    if i >= nd - 3 and d % data == 0 and d != batch:
                        lead[i] = "data"
                        break
            return tuple(lead)
        return tuple([None] * nd)

    return _map_tree(f, cache)


def placements_for(spec: tuple, mesh) -> list:
    """The ``DTensor`` placements of ``spec`` on the ``DeviceMesh``
    ``mesh``: ``Shard(d)`` on every mesh dim that tensor dim ``d`` names,
    ``Replicate()`` on the rest.  A dim over several axes shards over them
    in mesh order, as a ``NamedSharding`` of ``("pod", "data")`` does; a
    tuple out of mesh order is refused."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} over {group} is not in "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or
        (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def shardings_for(specs, mesh):
    """``specs`` (a tree of specs: a dict, list or tuple of them) with each
    spec replaced by ``(mesh, placements)``, the arguments that
    ``distribute_tensor`` and :func:`~repro_torch.distributed.checkpoint.
    restore_checkpoint` take."""
    if _is_spec(specs):
        return (mesh, placements_for(specs, mesh))
    if isinstance(specs, dict):
        return {k: shardings_for(v, mesh) for k, v in specs.items()}
    return type(specs)(shardings_for(v, mesh) for v in specs)


def explain(params: dict, mesh) -> list:
    """The ``(name, shape, logical_axis, reason)`` fallbacks to
    replication of :func:`param_pspecs`."""
    notes: list = []
    param_pspecs(params, mesh, notes)
    return notes


# --------------------------------------------------------------------------
# pane-batch sharding hooks (the engine's bucketed propagation launches)
# --------------------------------------------------------------------------


def pane_bucket_shards(nb: int, n_shards: int) -> list[slice]:
    """Balanced contiguous slices splitting a pane bucket's batch axis.

    The engine's :class:`~repro_torch.core.batch_exec.PaneBatchExecutor`
    takes this (partially applied over ``n_shards``) as its
    ``shard_slices`` hook: each returned slice becomes its own launch, so
    one size bucket of burst jobs can spread across devices or hosts.
    Empty shards are elided — ``nb < n_shards`` yields ``nb`` singleton
    slices.
    """
    if nb <= 0:
        return []
    n_shards = max(1, min(int(n_shards), nb))
    cuts = np.linspace(0, nb, n_shards + 1).round().astype(int)
    return [slice(int(a), int(b)) for a, b in zip(cuts[:-1], cuts[1:])
            if b > a]


def pane_batch_pspecs(mesh, ndim: int = 3) -> tuple:
    """Spec of a stacked pane bucket ``[nb, b, d]`` (or mask ``[nb, b,
    b]``): the batch-of-bursts axis over the data-parallel mesh axes; burst
    rows and basis columns stay local to the device."""
    return (_dp(mesh_axes(mesh))[0], *([None] * (ndim - 1)))


def shard_pane_bucket(arr, mesh):
    """A stacked pane bucket (a tensor every rank holds whole) as a
    ``DTensor`` with its batch axis split over the mesh's data-parallel
    axes.  Each rank keeps its own chunk of its copy (``src_data_rank=
    None``: nothing is sent); pad the leading axis to a multiple of the
    data-parallel size upstream, as the reference asks, for equal
    chunks."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(
        arr, mesh, placements_for(pane_batch_pspecs(mesh, arr.ndim), mesh),
        src_data_rank=None)
