"""Hand-written CUDA kernel for *dense* burst propagation (no edge predicates).

For a dense burst the adjacency is strictly-lower all-ones and
(I-L)^{-1}[i,j] = 2^{i-j-1}, so per column

    c_i = b_i + s_{i-1},   s_i = 2 s_{i-1} + b_i

(the paper's Table-3 doubling in closed form).  The kernel is
``csrc/hamlet_dense.cu`` (sm_90a; its header comment gives the design and
what bounds it).  It replaces the TPU kernel ``dense_propagate_pallas`` of
the JAX package (``src/repro/kernels/hamlet_dense.py``), which downcasts to
f32 and carries the running sum across 64-row MXU tiles; this kernel scans
the recurrence over fixed 16-row runs with one warp per batch element and
column chunk, in f64 for both input dtypes.  It adds in another order than
the numpy closed form: integer-valued f64 below 2^53 (COUNT) is exact,
other values agree to a few ulp, and a row's result does not depend on how
many zero rows are padded after it.

Beside it sits its plain version,
:func:`repro_torch.kernels.ref.prefix_propagate_dense_torch_batched`: the
wrapper takes it for a tensor that lies on the CPU, and only then.
"""

from __future__ import annotations

import collections

import torch

from . import _build, ref

__all__ = ["DENSE_B_MAX", "dense_propagate_cuda", "dense_propagate_work"]

# largest burst the dense closed form handles exactly (its 2^{+-i} weights
# stay finite and normal in f64); the engine's dense-eligibility test, the
# executor's fallback and this wrapper share it
DENSE_B_MAX = 512

_DTYPES = (torch.float64, torch.float32)


def dense_propagate_cuda(base: torch.Tensor) -> torch.Tensor:
    """base [nb, b, d] (f64 or f32, b <= DENSE_B_MAX) -> the dense-burst
    counts [nb, b, d].

    On a CUDA tensor this launches the kernel, counts the launch in
    ``dense_propagate_cuda.launches`` and its ``(nb, b, d, dtype)`` in the
    ``dense_propagate_cuda.shapes`` Counter; on a CPU tensor it runs the
    plain version; any other device raises.  b > DENSE_B_MAX raises on every
    device: the plain version's weights leave the f64 range there.
    """
    if base.dim() != 3:
        raise ValueError(f"base must be [nb, b, d], got {tuple(base.shape)}")
    if base.dtype not in _DTYPES:
        raise TypeError(f"base dtype {base.dtype}: need one of {_DTYPES}")
    nb, b, d = base.shape
    if b > DENSE_B_MAX:
        raise ValueError(f"dense closed form needs b <= {DENSE_B_MAX}, "
                         f"got {b}")
    if base.device.type == "cpu":
        return ref.prefix_propagate_dense_torch_batched(base)
    if base.device.type != "cuda":
        raise ValueError(f"no kernel for device {base.device}")
    if not base.is_contiguous():
        raise ValueError("base must be contiguous")
    if max(nb, d) >= 2 ** 31:
        raise ValueError(f"shape {(nb, b, d)} exceeds the kernel's int32 "
                         "extents")
    out = torch.empty_like(base)
    if base.numel():
        _build.load().dense_propagate(base, out)
        _build.count_launch(dense_propagate_cuda, (nb, b, d, str(
            base.dtype).removeprefix("torch.")))
    return out


dense_propagate_cuda.launches = 0
dense_propagate_cuda.shapes = collections.Counter()


def dense_propagate_work(nb: int, b: int, d: int,
                         itemsize: int = 8) -> tuple[float, float]:
    """The bytes and operations a dense propagation of ``[nb, b, d]`` must
    spend at the least: ``base`` read once and ``out`` written once, and
    three operations per element (``c = b + s`` and ``s = 2 s + b``).
    Returns ``(bytes, operations)``."""
    n = nb * b * d
    return float(2 * itemsize * n), 3.0 * n
