"""Pane-batch sharding hook for the engine's bucketed propagation launches.

:class:`~repro_torch.core.batch_exec.PaneBatchExecutor` takes a
``shard_slices`` callable that splits one size bucket of burst jobs into
sub-batches, each launched on its own (``HamletRuntime(...,
shard_slices=lambda nb: pane_bucket_shards(nb, n))``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["pane_bucket_shards"]


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
