"""Event stream data model.

Events are kept in struct-of-arrays form (``EventBatch``) so that panes can be
processed as dense tensors on the accelerator: integer type ids, integer
timestamps (ticks), a float attribute matrix, and an integer group key.

The paper's executor partitions the stream (i) by the values of the grouping
attributes and (ii) into panes whose size is the gcd of all window sizes and
slides (Sec. 3.1).  Both operations live here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "StreamSchema",
    "EventBatch",
    "pane_size_for",
    "split_panes",
]


@dataclass(frozen=True)
class StreamSchema:
    """Names of event types and attributes for a stream.

    ``types[i]`` has type id ``i``; ``attrs[j]`` is column ``j`` of
    ``EventBatch.attrs``.
    """

    types: tuple[str, ...]
    attrs: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if len(set(self.types)) != len(self.types):
            raise ValueError("duplicate event type names")
        if len(set(self.attrs)) != len(self.attrs):
            raise ValueError("duplicate attribute names")

    @property
    def n_types(self) -> int:
        return len(self.types)

    def type_id(self, name: str) -> int:
        try:
            return self.types.index(name)
        except ValueError:
            raise KeyError(f"unknown event type {name!r}; have {self.types}") from None

    def attr_col(self, name: str) -> int:
        try:
            return self.attrs.index(name)
        except ValueError:
            raise KeyError(f"unknown attribute {name!r}; have {self.attrs}") from None


@dataclass
class EventBatch:
    """A time-ordered batch of events (one group partition, any time span).

    type_id : int32[n]      index into schema.types
    time    : int64[n]      non-decreasing timestamps in ticks
    attrs   : float64[n, a] attribute values (column per schema.attrs entry)
    group   : int64[n]      group partition key (constant within a partition)
    seq     : int64[n]|None provenance: producer sequence / original arrival
                            index.  Optional; carried so that out-of-order
                            streams can be merged back into a *total* order
                            (ties on ``time`` break by ``seq``, see
                            :meth:`merge`).  The engine ignores it.

    Direct construction still requires time order; real traces with
    disordered arrival go through :meth:`from_unsorted`.
    """

    schema: StreamSchema
    type_id: np.ndarray
    time: np.ndarray
    attrs: np.ndarray
    group: np.ndarray = field(default=None)  # type: ignore[assignment]
    seq: np.ndarray | None = field(default=None)

    def __post_init__(self) -> None:
        n = len(self.type_id)
        self.type_id = np.asarray(self.type_id, dtype=np.int32)
        self.time = np.asarray(self.time, dtype=np.int64)
        n_attrs = max(1, len(self.schema.attrs))
        if self.attrs is None or np.size(self.attrs) == 0:
            self.attrs = np.zeros((n, n_attrs), dtype=np.float64)
        else:
            self.attrs = np.asarray(self.attrs, dtype=np.float64).reshape(n, -1)
        if self.group is None:
            self.group = np.zeros(n, dtype=np.int64)
        self.group = np.asarray(self.group, dtype=np.int64)
        if len(self.time) != n or len(self.attrs) != n or len(self.group) != n:
            raise ValueError("EventBatch arrays must share their leading dim")
        if self.seq is not None:
            self.seq = np.asarray(self.seq, dtype=np.int64)
            if len(self.seq) != n:
                raise ValueError("EventBatch arrays must share their leading dim")
        if n > 1 and np.any(np.diff(self.time) < 0):
            raise ValueError("events must be time-ordered "
                             "(use EventBatch.from_unsorted for raw traces)")

    def __len__(self) -> int:
        return len(self.type_id)

    def attr(self, name: str) -> np.ndarray:
        return self.attrs[:, self.schema.attr_col(name)]

    def select(self, idx: np.ndarray) -> "EventBatch":
        return EventBatch(
            schema=self.schema,
            type_id=self.type_id[idx],
            time=self.time[idx],
            attrs=self.attrs[idx],
            group=self.group[idx],
            seq=None if self.seq is None else self.seq[idx],
        )

    def time_slice(self, t0: int, t1: int) -> "EventBatch":
        """Events with t0 <= time < t1 (events are time sorted)."""
        lo = int(np.searchsorted(self.time, t0, side="left"))
        hi = int(np.searchsorted(self.time, t1, side="left"))
        return self.select(np.arange(lo, hi))

    @staticmethod
    def from_unsorted(schema: StreamSchema, type_id, time, attrs=None,
                      group=None, seq=None) -> "EventBatch":
        """Build a batch from arrays in *arrival* order (any time order).

        Events are stable-sorted by timestamp, so equal-timestamp events keep
        their relative arrival order.  ``seq`` records provenance: when not
        given, it is stamped with the original arrival index (position in the
        input arrays), so callers can always recover where a sorted event came
        from; producers that stamp their own sequence ids pass them through.
        """
        time = np.asarray(time, dtype=np.int64)
        n = len(time)
        seq = (np.arange(n, dtype=np.int64) if seq is None
               else np.asarray(seq, dtype=np.int64))
        order = np.argsort(time, kind="stable")
        if attrs is not None and np.size(attrs) == 0:
            attrs = None
        attrs = None if attrs is None else np.asarray(
            attrs, dtype=np.float64).reshape(n, -1)
        return EventBatch(
            schema=schema,
            type_id=np.asarray(type_id, dtype=np.int32)[order],
            time=time[order],
            attrs=None if attrs is None else attrs[order],
            group=(None if group is None
                   else np.asarray(group, dtype=np.int64)[order]),
            seq=seq[order],
        )

    @staticmethod
    def concat(batches: list["EventBatch"]) -> "EventBatch":
        if not batches:
            raise ValueError("need at least one batch")
        schema = batches[0].schema
        # provenance only survives when every part carries it; a partial
        # concat would silently misorder merge() ties
        seqs = [b.seq for b in batches]
        return EventBatch(
            schema=schema,
            type_id=np.concatenate([b.type_id for b in batches]),
            time=np.concatenate([b.time for b in batches]),
            attrs=np.concatenate([b.attrs for b in batches]),
            group=np.concatenate([b.group for b in batches]),
            seq=(np.concatenate(seqs) if all(s is not None for s in seqs)
                 else None),
        )

    @staticmethod
    def merge(batches: list["EventBatch"]) -> "EventBatch":
        """Merge time-sorted batches into one total order.

        Unlike :meth:`concat`, the inputs need not be globally ordered
        relative to each other.  Ties on ``time`` break by ``seq`` when
        every batch carries it (the producer's total order), else by batch
        order then position (stable) — the contract the event-time layer
        relies on to reconstruct the original stream from disordered
        arrivals.
        """
        if not batches:
            raise ValueError("need at least one batch")
        time = np.concatenate([b.time for b in batches])
        seqs = [b.seq for b in batches]
        seq = (np.concatenate(seqs) if all(s is not None for s in seqs)
               else None)
        if seq is not None:
            order = np.lexsort((seq, time))
        else:
            order = np.argsort(time, kind="stable")
        return EventBatch(
            schema=batches[0].schema,
            type_id=np.concatenate([b.type_id for b in batches])[order],
            time=time[order],
            attrs=np.concatenate([b.attrs for b in batches])[order],
            group=np.concatenate([b.group for b in batches])[order],
            seq=None if seq is None else seq[order],
        )

    def partition_by_group(self) -> dict[int, "EventBatch"]:
        out: dict[int, EventBatch] = {}
        for g in np.unique(self.group):
            out[int(g)] = self.select(np.nonzero(self.group == g)[0])
        return out


def pane_size_for(windows: list[tuple[int, int]]) -> int:
    """gcd of all window sizes and slides (Sec. 3.1)."""
    vals: list[int] = []
    for within, slide in windows:
        if within <= 0 or slide <= 0:
            raise ValueError("window/slide must be positive")
        vals.extend([within, slide])
    g = 0
    for v in vals:
        g = math.gcd(g, v)
    return max(1, g)


def split_panes(batch: EventBatch, pane: int, t_start: int, t_end: int):
    """Yield ``(pane_start_time, EventBatch)`` for [t_start, t_end) in steps."""
    for t0 in range(t_start, t_end, pane):
        yield t0, batch.time_slice(t0, t0 + pane)
