"""Hand-written CUDA kernel for *dense* burst propagation (no edge predicates).

For a dense burst the adjacency is strictly-lower all-ones and
(I-L)^{-1}[i,j] = 2^{i-j-1}, so per column

    c_i = b_i + s_{i-1},   s_i = 2 s_{i-1} + b_i

(the paper's Table-3 doubling in closed form).  The kernel is
``csrc/hamlet_dense.cu`` (sm_90a; its header comment gives the design and
what bounds it).  It replaces the TPU kernel ``dense_propagate_pallas`` of
the JAX package (``src/repro/kernels/hamlet_dense.py``), which downcasts to
f32 and carries the running sum across 64-row MXU tiles; this kernel runs
the recurrence in the input's dtype, so on the engine's f64 path it rounds
exactly like the numpy closed form.

Beside it sits its plain version,
:func:`repro_torch.kernels.ref.prefix_propagate_dense_torch_batched`: the
wrapper takes it for a tensor that lies on the CPU, and only then.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["dense_propagate_cuda"]

_DTYPES = (torch.float64, torch.float32)


def dense_propagate_cuda(base: torch.Tensor) -> torch.Tensor:
    """base [nb, b, d] (f64 or f32) -> the dense-burst counts [nb, b, d].

    On a CUDA tensor this launches the kernel (and counts the launch in
    ``dense_propagate_cuda.launches``); on a CPU tensor it runs the plain
    version; any other device raises.
    """
    if base.dim() != 3:
        raise ValueError(f"base must be [nb, b, d], got {tuple(base.shape)}")
    if base.dtype not in _DTYPES:
        raise TypeError(f"base dtype {base.dtype}: need one of {_DTYPES}")
    if base.device.type == "cpu":
        return ref.prefix_propagate_dense_torch_batched(base)
    if base.device.type != "cuda":
        raise ValueError(f"no kernel for device {base.device}")
    if not base.is_contiguous():
        raise ValueError("base must be contiguous")
    nb, b, d = base.shape
    if b > 2048 or max(nb, d) >= 2 ** 31:
        raise ValueError(f"shape {(nb, b, d)} exceeds the kernel's staging "
                         "tile (b <= 2048)")
    out = torch.empty_like(base)
    if base.numel():
        _build.load().dense_propagate(base, out)
        dense_propagate_cuda.launches += 1
    return out


dense_propagate_cuda.launches = 0
