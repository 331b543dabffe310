"""Device time of a kernel call on the card, and the least time the card
could take for the same work, for ``chip_smoke.py`` and
:mod:`repro_torch.kernels.masked_ab`."""

from __future__ import annotations

import statistics

import torch

__all__ = ["bound", "device_ms"]

# H100 SXM published peaks (NVIDIA data sheet; at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12,   # FP64 tensor-core rate: the type's peak
                  "float32": 67e12,   # float32 outside the tensor cores
                  "int32": 67e12}     # taken at the float32 rate


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """The larger of the bytes at the HBM rate and the operations at the
    type's peak, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, launches: int = 30, reps: int = 5, warmup: int = 3,
              spin: int = 50_000_000) -> float:
    """Device time of one call: ``launches`` calls enqueued back to back
    behind a spin kernel (``torch.cuda._sleep`` of ``spin`` cycles, ~25 ms
    by default), so the card runs them without waiting for the host, timed
    with CUDA events around the batch and divided by the count; the median
    of ``reps`` such batches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)             # covers the enqueueing
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)
