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
           "plain_loads"]

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
