"""Hand-written CUDA kernel for HAMLET's masked prefix propagation.

Solves (I - L) C = B per batch element, where L is strictly lower triangular
(the within-pane predecessor adjacency) and the columns of C are snapshot
coefficients (shared execution) or per-query channels (non-shared execution):

    c[i] = base[i] + sum_{j<i} mask[i, j] * c[j]

The kernel is ``csrc/hamlet_propagate.cu`` (sm_90a; its header comment gives
the design and what bounds it).  It replaces the TPU kernel
``masked_prefix_propagate_pallas`` of the JAX package
(``src/repro/kernels/hamlet_propagate.py``), which tiles rows by 128 for the
MXU; on Hopper the block walks 32-row tiles, one warp solving each tile by
forward substitution from registers while seven warps apply the solved
tiles' panels from ``cp.async`` rings.

Beside it sits its plain version,
:func:`repro_torch.kernels.ref.torch_prefix_propagate_batched`: the wrapper
takes it for a tensor that lies on the CPU, and only then.
"""

from __future__ import annotations

import collections

import torch

from . import _build, ref

__all__ = ["masked_prefix_propagate_cuda", "masked_propagate_work"]

_DTYPES = (torch.float64, torch.float32, torch.int32)


def masked_prefix_propagate_cuda(base: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Batched masked prefix propagation.

    base : [nb, b, d]  injection rows (f64, f32 or int32)
    mask : [nb, b, b]  adjacency of the same dtype; only the strictly lower
                       triangle is read
    returns [nb, b, d] with c[i] = base[i] + sum_{j<i} mask[i,j] c[j].

    On a CUDA tensor this launches the kernel, counts the launch in
    ``masked_prefix_propagate_cuda.launches`` and its ``(nb, b, d, dtype)``
    in the ``masked_prefix_propagate_cuda.shapes`` Counter; on a CPU tensor
    it runs the plain version; any other device raises.
    """
    if base.dim() != 3:
        raise ValueError(f"base must be [nb, b, d], got {tuple(base.shape)}")
    nb, b, d = base.shape
    if tuple(mask.shape) != (nb, b, b):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(nb, b, b)}")
    if base.dtype not in _DTYPES or mask.dtype != base.dtype:
        raise TypeError(f"base/mask dtypes {base.dtype}/{mask.dtype}: need "
                        f"one of {_DTYPES}, the same for both")
    if mask.device != base.device:
        raise ValueError("base and mask must be on one device")
    if base.device.type == "cpu":
        return ref.torch_prefix_propagate_batched(base, mask)
    if base.device.type != "cuda":
        raise ValueError(f"no kernel for device {base.device}")
    if not (base.is_contiguous() and mask.is_contiguous()):
        raise ValueError("base and mask must be contiguous")
    if max(nb, b, d) >= 2 ** 31:
        raise ValueError(f"shape {(nb, b, d)} exceeds the kernel's int32 "
                         "extents")
    out = torch.empty_like(base)
    if base.numel():
        _build.load().masked_propagate(base, mask, out)
        _build.count_launch(masked_prefix_propagate_cuda, (nb, b, d, str(
            base.dtype).removeprefix("torch.")))
    return out


masked_prefix_propagate_cuda.launches = 0
masked_prefix_propagate_cuda.shapes = collections.Counter()


def masked_propagate_work(nb: int, b: int, d: int,
                          itemsize: int = 8) -> tuple[float, float]:
    """The bytes and operations a masked propagation of ``[nb, b, d]`` must
    spend at the least: ``base`` read once, ``out`` written once and the
    strict lower triangle of the mask read once (no entry on or above the
    diagonal is needed), and one multiply and one add per strict-lower mask
    entry and column.  Returns ``(bytes, operations)``."""
    tri = nb * b * (b - 1) / 2
    return float(itemsize * (2 * nb * b * d + tri)), 2.0 * d * tri
