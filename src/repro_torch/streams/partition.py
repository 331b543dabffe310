"""Group-key partitioning into shards.

The paper's executor partitions the stream by grouping attributes
(Sec. 3.1); group partitions are independent, so they can go to separate
shards (processes, devices).  ``shard_by_group`` buckets events into
``n_shards`` contiguous per-shard batches, padded to a common length so the
result is a dense [n_shards, cap, ...] array set.  Host numpy, bitwise the
JAX package's partitioning.
"""

from __future__ import annotations

import numpy as np

from ..core.events import EventBatch

__all__ = ["shard_by_group", "PaddedShards"]


class PaddedShards:
    """Dense per-shard arrays with a validity mask."""

    def __init__(self, type_id, time, attrs, group, valid):
        self.type_id = type_id      # [s, cap] int32
        self.time = time            # [s, cap] int64
        self.attrs = attrs          # [s, cap, a] f32
        self.group = group          # [s, cap] int64
        self.valid = valid          # [s, cap] bool

    @property
    def n_shards(self) -> int:
        return self.type_id.shape[0]

    @property
    def capacity(self) -> int:
        return self.type_id.shape[1]

    @property
    def counts(self) -> np.ndarray:
        """Valid events per shard, shape [n_shards]."""
        return self.valid.sum(axis=1)

    def occupancy(self) -> float:
        """Fraction of the dense [s, cap] slab holding real events — the
        padding waste a skewed group distribution causes (1.0 = perfectly
        balanced, -> 1/n_shards when one shard holds everything)."""
        if self.valid.size == 0:
            return 0.0
        return float(self.valid.mean())


def shard_by_group(batch: EventBatch, n_shards: int,
                   capacity: int | None = None) -> PaddedShards:
    shard_of = (batch.group % n_shards).astype(np.int64)
    counts = np.bincount(shard_of, minlength=n_shards)
    cap = int(counts.max()) if capacity is None else capacity
    cap = max(cap, 1)

    type_id = np.zeros((n_shards, cap), dtype=np.int32)
    time = np.zeros((n_shards, cap), dtype=np.int64)
    attrs = np.zeros((n_shards, cap, batch.attrs.shape[1]), dtype=np.float32)
    group = np.zeros((n_shards, cap), dtype=np.int64)
    valid = np.zeros((n_shards, cap), dtype=bool)
    for s in range(n_shards):
        idx = np.nonzero(shard_of == s)[0][:cap]
        m = len(idx)
        type_id[s, :m] = batch.type_id[idx]
        time[s, :m] = batch.time[idx]
        attrs[s, :m] = batch.attrs[idx]
        group[s, :m] = batch.group[idx]
        valid[s, :m] = True
    return PaddedShards(type_id, time, attrs, group, valid)
