"""Sharded multi-tenant service tier over the HAMLET pane dataplane.

Partitions tenants (contiguous group ranges) across N shard workers, each
owning an unchanged single-process stack — ``HamletRuntime`` +
``PaneMicroBatcher`` + overload PID loop + error accountant — and adds the
three things group-independence does not give for free:

* :mod:`placement` — deterministic consistent-hash routing with an
  override table for targeted, warmth-preserving rebalances;
* :mod:`admission` — global admission control: shed at the router before
  any queue, aggregate every accountant into one fleet certificate;
* :mod:`coordinator` — aligned-epoch watermark alignment: fleet-final
  progress that excludes laggards instead of waiting on them;
* :mod:`service` — the composed ``ShardedHamletService`` (router, shard
  workers, rebalance barriers, merged read side);
* :mod:`procdrive` — ``parallel="process"``: each shard worker pinned in
  a long-lived spawn process (chunks via shared memory, rendezvous over
  the command pipe) so shard drive cycles overlap past the GIL.

Differential contract (tested): with ``none``/``global_fixed`` admission
the N-shard service's results are a permutation-stable bitwise match of
the 1-shard service on the same stream on the ``np`` backend; on the
device backends (the default is the CUDA kernels on ``cuda:0``) COUNT is
exact and the other values agree to rtol 1e-12 (``service`` module
docstring).
"""

from .admission import ADMISSION_MODES, GlobalAdmissionController  # noqa: F401
from .coordinator import WatermarkAligner  # noqa: F401
from .placement import PlacementTable, ring_hash  # noqa: F401
from .procdrive import ProcShardWorker  # noqa: F401
from .service import (ShardedHamletService, ShardServiceConfig,  # noqa: F401
                      ShardWorker)
