"""The benchmark's frozen yardstick for kernels: the card's published peaks
and the least work each of the port's propagation kernels must do for a
launch shape, copied from the port's ``kernels/timing.py``,
``hamlet_propagate.masked_propagate_work`` and
``hamlet_dense.dense_propagate_work`` so that they read the same work
whatever implements the kernel."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12,   # FP64 tensor-core rate
                  "float32": 67e12,   # float32 outside the tensor cores
                  "int32": 67e12}     # taken at the float32 rate
ITEMSIZE = {"float64": 8, "float32": 4, "int32": 4}


def masked_propagate_work(nb: int, b: int, d: int,
                          itemsize: int = 8) -> tuple[float, float]:
    """``c[i] = base[i] + sum_{j<i} mask[i, j] c[j]`` over ``[nb, b, d]``:
    ``base`` read once, ``out`` written once, the mask's strict lower
    triangle read once; a multiply and an add per strict-lower entry and
    column.  ``(bytes, operations)``."""
    tri = nb * b * (b - 1) / 2
    return float(itemsize * (2 * nb * b * d + tri)), 2.0 * d * tri


def dense_propagate_work(nb: int, b: int, d: int,
                         itemsize: int = 8) -> tuple[float, float]:
    """The all-ones adjacency in closed form over ``[nb, b, d]``: ``base``
    read once, ``out`` written once, three operations an element.
    ``(bytes, operations)``."""
    n = nb * b * d
    return float(2 * itemsize * n), 3.0 * n


WORK = {"masked_propagate": masked_propagate_work,
        "dense_propagate": dense_propagate_work}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at the type's peak, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])


def shapes_bound_s(kernel: str, shapes: dict) -> float:
    """Summed bound over launches ``{(nb, b, d, dtype): count}``."""
    work = WORK[kernel]
    return sum(n * bound_s(*work(nb, b, d, ITEMSIZE[dt]), dt)
               for (nb, b, d, dt), n in shapes.items())
