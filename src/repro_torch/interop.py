"""Carry streams and workloads across packages as plain values.

The port never imports the JAX package, so a stream or workload made there
crosses over as plain data: numpy columns and name tuples for a stream, and
a *query spec* of nested tuples, dicts and numbers for a workload.
:func:`stream_columns` and :func:`workload_spec` read any object laid out
like this package's ``EventBatch`` / ``Workload`` (the JAX package's have
the same attributes); :func:`schema_from`, :func:`batch_from` and
:func:`workload_from` build the port's objects from the plain values.

Query spec: one dict per query with ``name``, ``pattern``, ``aggs``
(``(kind, type_name, attr)`` triples), ``preds`` (type -> ``(attr, op,
value)`` triples), ``edge_preds`` (type -> ``(attr, op)`` pairs),
``within``, ``slide`` and ``group_by``.  A pattern is a nested tuple:
``("type", name)``, ``("kleene", p)``, ``("not", p)``, ``("seq", (p, ...))``,
``("or", p, q)`` or ``("and", p, q)``.

Model weights cross as a tree of numpy arrays laid out like the JAX
package's ``init_params`` tree (nested dicts and tuples, the scanned cycle
groups stacked on a leading axis): :func:`lm_state_from` names every leaf
as the port's ``LM`` names its parameter, and :func:`lm_params_from`
builds the port's model from it (:func:`tree_state` and
:func:`load_state` do the same for one block's tree and module).
:func:`adamw_state_from` carries the reference AdamW's ``{"step", "m",
"v"}`` state the same way, and :func:`ef_errors_from` the compressed
step's error feedback, so a JAX training state continues in the port.

What crosses a process or a socket as a pickle holds builtins and numpy
only — the wire protocol's HELLO and END frames, whose reader may be the
JAX package's client or server, and the replies of a process-mode shard
worker.  :func:`plain_loads` unpickles such bytes and refuses any other
class, a tensor or an object of this package among them.
"""

from __future__ import annotations

import io
import pickle

import numpy as np

from .core.events import EventBatch, StreamSchema
from .core.pattern import And, EventType, Kleene, Not, Or, Seq
from .core.query import Agg, EdgePred, Pred, Query, Workload

__all__ = ["schema_from", "batch_from", "stream_columns", "pattern_spec",
           "pattern_from", "workload_spec", "workload_from",
           "tree_state", "load_state", "lm_state_from", "lm_params_from",
           "adamw_state_from", "ef_errors_from", "plain_loads"]

_UNARY = {"kleene": Kleene, "not": Not}
_BINARY = {"or": Or, "and": And}


def schema_from(types, attrs=()) -> StreamSchema:
    """The port's schema from type and attribute name sequences."""
    return StreamSchema(types=tuple(types), attrs=tuple(attrs))


def batch_from(schema: StreamSchema, type_id, time, attrs=None, group=None,
               seq=None) -> EventBatch:
    """The port's event batch from numpy columns (copied, so the source
    arrays stay independent)."""
    def cp(x):
        return None if x is None else np.array(x, copy=True)

    return EventBatch(schema, cp(type_id), cp(time), cp(attrs), cp(group),
                      cp(seq))


def stream_columns(batch) -> dict:
    """Plain columns of an event batch: ``types``/``attrs_names`` name
    tuples plus ``type_id``/``time``/``attrs``/``group``/``seq`` arrays."""
    return {"types": tuple(batch.schema.types),
            "attr_names": tuple(batch.schema.attrs),
            "type_id": batch.type_id, "time": batch.time,
            "attrs": batch.attrs, "group": batch.group, "seq": batch.seq}


def pattern_spec(p) -> tuple:
    """Nested-tuple spec of a pattern tree (read by class name)."""
    kind = type(p).__name__
    if kind == "EventType":
        return ("type", p.name)
    if kind in ("Kleene", "Not"):
        return (kind.lower(), pattern_spec(p.inner))
    if kind == "Seq":
        return ("seq", tuple(pattern_spec(q) for q in p.parts))
    if kind in ("Or", "And"):
        return (kind.lower(), pattern_spec(p.left), pattern_spec(p.right))
    raise TypeError(f"unknown pattern node {kind}")


def pattern_from(spec: tuple):
    """The port's pattern tree from its nested-tuple spec."""
    kind = spec[0]
    if kind == "type":
        return EventType(spec[1])
    if kind in _UNARY:
        return _UNARY[kind](pattern_from(spec[1]))
    if kind == "seq":
        return Seq(*(pattern_from(q) for q in spec[1]))
    if kind in _BINARY:
        return _BINARY[kind](pattern_from(spec[1]), pattern_from(spec[2]))
    raise ValueError(f"unknown pattern spec {kind!r}")


def workload_spec(workload) -> dict:
    """Plain spec of a workload: schema names, sharing mode and queries."""
    queries = []
    for q in workload.queries:
        queries.append({
            "name": q.name,
            "pattern": pattern_spec(q.pattern),
            "aggs": tuple((a.kind, a.type_name, a.attr) for a in q.aggs),
            "preds": {t: tuple((p.attr, p.op, float(p.value)) for p in ps)
                      for t, ps in (q.preds or {}).items()},
            "edge_preds": {t: tuple((e.attr, e.op) for e in es)
                           for t, es in (q.edge_preds or {}).items()},
            "within": int(q.within), "slide": int(q.slide),
            "group_by": tuple(q.group_by)})
    return {"types": tuple(workload.schema.types),
            "attrs": tuple(workload.schema.attrs),
            "sharable_mode": workload.sharable_mode, "queries": queries}


def workload_from(spec: dict) -> Workload:
    """The port's workload from a :func:`workload_spec` dict."""
    schema = schema_from(spec["types"], spec["attrs"])
    queries = [Query(
        q["name"], pattern_from(q["pattern"]),
        aggs=tuple(Agg(*a) for a in q["aggs"]),
        preds={t: [Pred(*p) for p in ps] for t, ps in q["preds"].items()}
        or None,
        edge_preds={t: [EdgePred(*e) for e in es]
                    for t, es in q["edge_preds"].items()} or None,
        within=q["within"], slide=q["slide"], group_by=q["group_by"])
        for q in spec["queries"]]
    return Workload(schema, queries,
                    sharable_mode=spec.get("sharable_mode", "units"))


def _leaves(tree, prefix: str):
    """(dotted name, leaf) pairs of a tree of dicts, tuples and arrays."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def lm_state_from(cfg, tree: dict) -> dict:
    """The port's parameter names -> arrays of a JAX ``init_params`` tree:
    the cycle groups unstacked in layer order (layer ``g * len(cycle) +
    ci`` is ``tree["scan"][ci]``'s slice g), then the tail, the shared
    block and the encoder's stacked layers."""
    cyc, n_groups, _ = cfg.layer_plan()
    out = {}
    for key in ("embed", "final_norm", "lm_head"):
        if key in tree:
            out[key] = tree[key]
    for ci, group in enumerate(tree["scan"]):
        for name, a in _leaves(group, ""):
            for g in range(n_groups):
                out[f"layers.{g * len(cyc) + ci}.{name}"] = a[g]
    for i, layer in enumerate(tree["tail"]):
        for name, a in _leaves(layer, ""):
            out[f"layers.{n_groups * len(cyc) + i}.{name}"] = a
    if "shared_block" in tree:
        for name, a in _leaves(tree["shared_block"], "shared_block."):
            out[name] = a
    if "enc" in tree:
        for name, a in _leaves(tree["enc"]["scan"], ""):
            for g in range(cfg.n_enc_layers):
                out[f"enc.layers.{g}.{name}"] = a[g]
        out["enc.final_norm"] = tree["enc"]["final_norm"]
    return out


def tree_state(tree) -> dict:
    """Dotted name -> leaf of a nested tree of dicts, tuples and arrays
    (the parameter names of the module laid out like it)."""
    return dict(_leaves(tree, ""))


def load_state(module, state: dict):
    """Copy ``state`` (parameter name -> numpy array) into ``module``'s
    parameters, each cast to its parameter's type; the names must be
    exactly the module's.  Give bf16 weights as float32 arrays (exact); an
    ``ml_dtypes`` bfloat16 array is widened.  Returns ``module``."""
    import torch

    params = dict(module.named_parameters())
    if state.keys() != params.keys():
        raise ValueError(
            f"state and module differ: missing "
            f"{sorted(params.keys() - state.keys())}, extra "
            f"{sorted(state.keys() - params.keys())}")
    with torch.no_grad():
        for name, a in state.items():
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                a = a.astype(np.float32)
            p = params[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {a.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(a))
    return module


def lm_params_from(cfg, tree: dict, *, dtype=None, device=None):
    """The port's ``LM`` with the weights of a JAX ``init_params`` tree of
    numpy arrays (:func:`lm_state_from`, :func:`load_state`), each cast to
    its parameter's type (``dtype``, default the config's; float32 leaves
    stay float32).  ``device`` defaults to ``cuda:0`` and raises without a
    GPU."""
    from .models.lm import LM, resolve_device

    dev = resolve_device(device)
    model = LM(cfg, device="meta", dtype=dtype).to_empty(device=dev)
    return load_state(model, lm_state_from(cfg, tree))


def adamw_state_from(cfg, opt_state: dict, *, device=None) -> dict:
    """The port's AdamW state (``{"step", "m", "v"}``, the moments named as
    :func:`lm_state_from` names the parameters) from the reference AdamW's
    state of a JAX ``init_params`` tree, as numpy arrays.  Each moment keeps
    its type (float32, or bfloat16 widened exactly and narrowed back).
    ``device`` defaults to ``cuda:0`` and raises without a GPU."""
    import torch

    from .models.lm import resolve_device

    dev = resolve_device(device)

    def tensor(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32), device=dev).bfloat16()
        return torch.tensor(a, device=dev)

    return {"step": torch.tensor(int(np.asarray(opt_state["step"])),
                                 dtype=torch.int32, device=dev),
            **{key: {n: tensor(a) for n, a in
                     lm_state_from(cfg, opt_state[key]).items()}
               for key in ("m", "v")}}


def _swap_pods(tree):
    """Each leaf of a tree of dicts and tuples with its first two axes
    swapped: ``[n_pods, G, ...]`` -> ``[G, n_pods, ...]``."""
    if isinstance(tree, dict):
        return {k: _swap_pods(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_swap_pods(v) for v in tree)
    return np.swapaxes(np.asarray(tree), 0, 1)


def ef_errors_from(cfg, errors: dict, *, device=None) -> dict:
    """The port's error-feedback state (parameter name -> ``[n_pods,
    *shape]`` float32, as ``dp_compressed_step_fn``'s ``init_errors``
    makes it) from the reference's ``init_errors`` tree of numpy arrays,
    whose leaves are ``[n_pods, ...]`` over an ``init_params`` tree (the
    scanned groups' ``[n_pods, G, ...]``), unstacked as
    :func:`lm_state_from` unstacks.  Also maps any tree laid out so, such
    as per-pod gradients.  ``device`` defaults to ``cuda:0`` and raises
    without a GPU."""
    import torch

    from .models.lm import resolve_device

    dev = resolve_device(device)
    tree = dict(errors)
    tree["scan"] = _swap_pods(errors["scan"])
    if "enc" in errors:
        tree["enc"] = {**errors["enc"],
                       "scan": _swap_pods(errors["enc"]["scan"])}
    return {n: torch.tensor(np.ascontiguousarray(a, np.float32), device=dev)
            for n, a in lm_state_from(cfg, tree).items()}


# the top-level modules whose classes a plain pickle may name
_PLAIN_ROOTS = frozenset({"builtins", "numpy", "collections", "copyreg",
                          "_codecs"})


class _PlainUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".", 1)[0] not in _PLAIN_ROOTS:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not a builtin or numpy type")
        return super().find_class(module, name)


def plain_loads(data: bytes):
    """Unpickle ``data``, which must name builtins and numpy types only
    (raises ``pickle.UnpicklingError`` on any other class)."""
    return _PlainUnpickler(io.BytesIO(data)).load()
