"""Per-rank collective, traffic and FLOP counts of an eager trace: the
port's twin of ``repro.launch.hlo_analysis``.

The reference parses compiled, post-SPMD HLO text and weights each while
body by its trip count, because XLA's cost analysis counts a loop body
once.  The port emits no HLO: its lowering proofs run the program itself,
eagerly, on ``meta`` tensors (``DTensor``s on a placeholder world, see
``launch.mesh.placeholder_world``).  :class:`CollectiveCounter` is a
``TorchDispatchMode`` over that run.  Like torch's ``CommDebugMode`` it
lets a ``DTensor`` op desugar first and then sees what one rank runs:
every local aten op and every collective, with its local shapes.  It
reports, in the reference's :class:`HloReport` shape:

* ``collective_bytes`` / ``collective_counts``: per kind (the reference's
  five, mapped from torch's functional collectives), bytes per rank from
  each collective's local result shape, plus ``"total"``;
* ``traffic_bytes``: operand plus result bytes of every aten op the rank
  runs, views and waits left out.  It is the eager counterpart of the
  reference's per-instruction estimate, but it counts unfused
  intermediates (every elementwise op reads and writes memory here),
  which the reference's fusions keep internal: read it as an upper
  estimate of HBM traffic;
* ``whiles``: always ``[]``.  An eager trace runs every layer and every
  loop iteration, so there is no trip count to correct;
* ``flops`` (beyond the reference's record): the rank's matrix-product
  FLOPs, from ``torch.utils.flop_counter``'s formulas (the ones
  ``FlopCounterMode`` uses) on the local shapes.

:class:`MatmulFlops`, the counter's FLOP part alone, counts a real step
on plain tensors at little cost, split by the products' types.

On a mesh of ``cpu`` devices, DTensor moves a shard between tensor dims
with an all-gather and a chunk where a GPU mesh would use an all-to-all
(torch logs "CPU process group does not support alltoall"), so
placeholder traces report such moves as all-gathers.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["CollectiveCounter", "MatmulFlops", "HloReport", "COLLECTIVES"]

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# torch's collective ops (functional, functional with autograd, and the
# c10d in-place ops) by name -> the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd", "c10d")
_PROPAGATION_FILE = os.path.join("distributed", "tensor", "_sharding_prop.py")
_NO_TRAFFIC = {"wait_tensor", "empty", "empty_like", "empty_strided",
               "_wrap_tensor_autograd"}


@dataclass
class HloReport:
    collective_bytes: dict
    collective_counts: dict
    traffic_bytes: float
    flop_weighted_note: str = ""
    whiles: list = field(default_factory=list)
    flops: float = 0.0


def _in_sharding_propagation() -> bool:
    """Whether the caller runs inside DTensor's sharding propagation,
    whose shape inference dispatches ops (on fake tensors, and their meta
    kernels on plain ``meta`` ones) that no rank runs."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION_FILE):
            return True
        f = f.f_back
    return False


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


class MatmulFlops(TorchDispatchMode):
    """Matrix-product FLOPs of the ops run inside the ``with`` block, from
    ``torch.utils.flop_counter``'s formulas: ``flops`` in all, and
    ``flops_by_dtype`` by the type of each product's result (e.g.
    ``{"bfloat16": ..., "float32": ...}``), which sets the peak rate it
    runs at.  It looks at nothing else, so a step of plain tensors runs
    under it at little cost."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.flops_by_dtype = {}

    def _count(self, func, args, kwargs, out) -> None:
        flop = self._flop_registry.get(getattr(func, "_overloadpacket", None))
        if flop is None:
            return
        n = flop(*args, **kwargs, out_val=out)
        res = next(t for t in tree_flatten(out)[0]
                   if isinstance(t, torch.Tensor))
        dt = str(res.dtype).removeprefix("torch.")
        self.flops += n
        self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out


class CollectiveCounter(MatmulFlops):
    """Counts, over the ops dispatched inside the ``with`` block, what one
    rank runs: collectives by kind (bytes from local result shapes),
    operand plus result bytes of every other op, and matrix-product FLOPs.
    ``report()`` gives them as a :class:`HloReport`.

    A collective the reference has no kind for (a broadcast, a scatter)
    raises ``ValueError``: nothing is dropped from the counts unseen."""

    def __init__(self):
        super().__init__()
        self.collective_bytes = {k: 0 for k in COLLECTIVES}
        self.collective_counts = {k: 0 for k in COLLECTIVES}
        self.traffic_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # let the DTensor desugar into the rank's local ops and its
            # collectives, which come back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        if (any(issubclass(t, FakeTensor) for t in types)
                or _in_sharding_propagation()):
            # DTensor's shape inference runs an op once on fake tensors
            # of the global shapes: no rank runs it
            return out
        if not isinstance(func, torch._ops.OpOverload):
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _NAMESPACES and name not in _NO_TRAFFIC:
            kind = _KINDS.get(name)
            if kind is None:
                raise ValueError(f"collective {ns}.{name} has no kind among "
                                 f"{COLLECTIVES}")
            self.collective_bytes[kind] += _bytes(tree_flatten(out)[0])
            self.collective_counts[kind] += 1
        if func.is_view or name in _NO_TRAFFIC:
            return out
        ins = tree_flatten((args, kwargs))[0]
        self.traffic_bytes += _bytes(ins) + _bytes(tree_flatten(out)[0])
        self._count(func, args, kwargs, out)
        return out

    def report(self) -> HloReport:
        cb = {k: float(v) for k, v in self.collective_bytes.items()}
        cb["total"] = sum(cb[k] for k in COLLECTIVES)
        return HloReport(cb, dict(self.collective_counts),
                         float(self.traffic_bytes), whiles=[],
                         flops=float(self.flops))
