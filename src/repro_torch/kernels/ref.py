"""Reference oracles for the masked prefix-propagation primitive.

The primitive solves the paper's Eq. 1 in batched matrix form: given per-event
injection rows ``base`` [b, d] and a strictly-lower-triangular adjacency
``mask`` [b, b],

    c[i] = base[i] + sum_{j < i} mask[i, j] * c[j]

i.e. ``(I - L) C = B`` with unit diagonal.  ``d`` is the snapshot-basis width
for HAMLET's shared propagation (coefficient rows), or the number of parallel
per-query channels for non-shared GRETA propagation.

Two families live here:

* the numpy host oracles (``numpy_*`` / ``*_np``) — the ``"np"`` backend of
  :mod:`repro_torch.kernels.ops`, kept operation for operation as the JAX
  package has them;
* their plain PyTorch twins (``torch_*`` / ``*_torch``) — the ``"torch"``
  backend on any device, and the plain versions the hand-written CUDA
  kernels (``hamlet_propagate.py``, ``hamlet_dense.py``) are held against.
  Each torch twin repeats its numpy oracle's arithmetic (same formulation,
  same operation order where torch allows), so on the CPU the two agree
  bitwise wherever the values are exact and to rounding elsewhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "numpy_prefix_propagate",
    "numpy_prefix_propagate_fast",
    "numpy_prefix_propagate_batched",
    "numpy_prefix_propagate_fast_batched",
    "prefix_propagate_dense_np",
    "prefix_propagate_dense_np_batched",
    "torch_prefix_propagate",
    "torch_prefix_propagate_batched",
    "torch_prefix_propagate_fast",
    "torch_prefix_propagate_fast_batched",
    "prefix_propagate_dense_torch",
    "prefix_propagate_dense_torch_batched",
    "exact_oracle",
]


# --------------------------------------------------------------------------
# numpy host oracles (the "np" backend)
# --------------------------------------------------------------------------


def numpy_prefix_propagate(base: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Row-by-row host oracle; dtype-generic (exact for integer dtypes)."""
    b, _ = base.shape
    c = np.zeros_like(base)
    for i in range(b):
        c[i] = base[i]
        if i:
            c[i] = c[i] + mask[i, :i].astype(base.dtype) @ c[:i]
    return c


def exact_oracle(doubling: float, row_loop: float) -> tuple[float, str]:
    """What the ``"cuda"`` path is held against for one window value: the
    numpy path's (the doubling, :func:`numpy_prefix_propagate_fast`, for
    b >= 25), except where the doubling is non-finite and the row loop
    (:func:`numpy_prefix_propagate`, the exact path and the masked
    kernel's plain version) is finite: there the row loop.  Returns the
    value and which oracle gave it."""
    if not math.isfinite(doubling) and math.isfinite(row_loop):
        return row_loop, "row loop"
    return doubling, "doubling"


def numpy_prefix_propagate_fast(base: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Neumann-doubling host path: (I-L)^{-1} B = prod_i (I + L^{2^i}) B —
    log2(b) BLAS matmuls instead of b Python-level row steps.  Exact while
    path counts stay below 2^53 (f64); beyond that counts saturate."""
    b, _ = base.shape
    if b <= 2:
        return numpy_prefix_propagate(base, mask)
    L = np.tril(mask, k=-1).astype(np.float64, copy=True)
    c = base.astype(np.float64, copy=True)
    n_iters = max(1, math.ceil(math.log2(b)))
    with np.errstate(over="ignore", invalid="ignore"):
        for it in range(n_iters):
            c += L @ c
            if it + 1 < n_iters:
                L = L @ L
    return c.astype(base.dtype, copy=False)


def numpy_prefix_propagate_batched(base: np.ndarray,
                                   mask: np.ndarray) -> np.ndarray:
    """Stacked twin of :func:`numpy_prefix_propagate`: the same row-by-row
    recurrence, vectorized across the batch — row i of every slice advances
    with one batched vecmat.  Each slice is bitwise equal to the unbatched
    oracle (dtype-generic, exact for integer dtypes)."""
    nb, b, _ = base.shape
    c = np.zeros_like(base)
    for i in range(b):
        c[:, i] = base[:, i]
        if i:
            c[:, i] += np.matmul(
                mask[:, i, None, :i].astype(base.dtype), c[:, :i])[:, 0]
    return c


def numpy_prefix_propagate_fast_batched(base: np.ndarray,
                                        mask: np.ndarray) -> np.ndarray:
    """Stacked twin of :func:`numpy_prefix_propagate_fast`: one Neumann-
    doubling sweep over a whole batch ``base [nb, b, d]`` / ``mask
    [nb, b, b]``; each slice is bitwise equal to the unbatched call."""
    nb, b, _ = base.shape
    if b <= 2:
        return np.stack([numpy_prefix_propagate(base[i], mask[i])
                         for i in range(nb)])
    L = np.tril(mask, k=-1).astype(np.float64, copy=True)
    c = base.astype(np.float64, copy=True)
    n_iters = max(1, math.ceil(math.log2(b)))
    with np.errstate(over="ignore", invalid="ignore"):
        for it in range(n_iters):
            c += np.matmul(L, c)
            if it + 1 < n_iters:
                L = np.matmul(L, L)
    return c.astype(base.dtype, copy=False)


def prefix_propagate_dense_np(base: np.ndarray) -> np.ndarray:
    """Closed form for a *dense* burst (mask = strictly-lower all-ones, the
    no-edge-predicate common case): (I-L)^{-1}[i,j] = 2^{i-j-1}, so with
    s_i = sum_{j<=i} c_j the recurrence collapses to s_i = 2 s_{i-1} + b_i —
    an exponentially weighted cumsum, O(b*d) instead of O(b^2*d log b).
    This is the paper's own Table-3 doubling taken to its closed form.
    Exact for powers of two in f64 up to the saturation regime; falls back
    upstream for b > 512."""
    b, d = base.shape
    i = np.arange(b, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        t = np.cumsum((2.0 ** -i)[:, None] * base, axis=0)
        s = (2.0 ** i)[:, None] * t                 # s_i = sum_{j<=i} c_j
        c = base.astype(np.float64, copy=True)
        c[1:] += s[:-1]
    return c.astype(base.dtype, copy=False)


def prefix_propagate_dense_np_batched(base: np.ndarray) -> np.ndarray:
    """Stacked twin of :func:`prefix_propagate_dense_np` for ``base
    [nb, b, d]``; slices are bitwise equal to the unbatched call, and zero
    row/column padding never perturbs the real region."""
    nb, b, d = base.shape
    i = np.arange(b, dtype=np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        t = np.cumsum((2.0 ** -i)[None, :, None] * base, axis=1)
        s = (2.0 ** i)[None, :, None] * t
        c = base.astype(np.float64, copy=True)
        c[:, 1:] += s[:, :-1]
    return c.astype(base.dtype, copy=False)


# --------------------------------------------------------------------------
# plain PyTorch twins (the "torch" backend; the CUDA kernels' plain versions)
# --------------------------------------------------------------------------


def torch_prefix_propagate_batched(base: torch.Tensor,
                                   mask: torch.Tensor) -> torch.Tensor:
    """Forward substitution over ``base [nb, b, d]`` / ``mask [nb, b, b]``:
    twin of :func:`numpy_prefix_propagate_batched`, and the plain version of
    the masked CUDA kernel.  Row ``i`` reads only ``mask[:, i, :i]`` (the
    upper triangle and the diagonal are ignored) and multiplies every entry,
    zeros included, so ``0 * inf`` gives NaN exactly where the oracle does.
    Integer dtypes accumulate exactly, wrapping like the oracle's int32
    arithmetic."""
    nb, b, d = base.shape
    c = torch.zeros_like(base)
    integer = not base.dtype.is_floating_point
    m = mask.to(base.dtype)
    for i in range(b):
        if i == 0:
            c[:, 0] = base[:, 0]
        elif integer:
            # no integer matmul on CUDA: products wrap in the input dtype,
            # the widened sum wraps back on the cast (arithmetic mod 2^32)
            acc = (m[:, i, :i, None] * c[:, :i]).sum(dim=1)
            c[:, i] = (base[:, i] + acc).to(base.dtype)
        else:
            c[:, i] = base[:, i] + torch.matmul(m[:, i, None, :i],
                                                c[:, :i])[:, 0]
    return c


def torch_prefix_propagate(base: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Unbatched :func:`torch_prefix_propagate_batched`: ``[b, d]``."""
    return torch_prefix_propagate_batched(base[None], mask[None])[0]


def torch_prefix_propagate_fast_batched(base: torch.Tensor,
                                        mask: torch.Tensor) -> torch.Tensor:
    """Neumann doubling over a batch: twin of
    :func:`numpy_prefix_propagate_fast_batched` (float64 arithmetic, the
    result cast back to the input dtype)."""
    nb, b, _ = base.shape
    if b <= 2:
        return torch_prefix_propagate_batched(base, mask)
    L = torch.tril(mask, diagonal=-1).to(torch.float64)
    c = base.to(torch.float64, copy=True)
    n_iters = max(1, math.ceil(math.log2(b)))
    for it in range(n_iters):
        c += torch.matmul(L, c)
        if it + 1 < n_iters:
            L = torch.matmul(L, L)
    return c.to(base.dtype)


def torch_prefix_propagate_fast(base: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Unbatched :func:`torch_prefix_propagate_fast_batched`: ``[b, d]``."""
    return torch_prefix_propagate_fast_batched(base[None], mask[None])[0]


def prefix_propagate_dense_torch_batched(base: torch.Tensor) -> torch.Tensor:
    """Dense-burst closed form over ``base [nb, b, d]``: twin of
    :func:`prefix_propagate_dense_np_batched` and the plain version of the
    dense CUDA kernel.  Scaling by powers of two is exact, so the weighted
    cumsum rounds exactly like the sequential recurrence
    ``s_i = 2 s_{i-1} + b_i`` (float64 arithmetic, cast back to the input
    dtype); the kernel scans the recurrence in another order, exact where
    the values are integers below 2^53."""
    nb, b, d = base.shape
    # exact powers of two from the host (a device pow/exp2 may round)
    i = np.arange(b, dtype=np.float64)
    up = torch.as_tensor(2.0 ** i, device=base.device)
    down = torch.as_tensor(2.0 ** -i, device=base.device)
    x = base.to(torch.float64)
    t = torch.cumsum(down[None, :, None] * x, dim=1)
    s = up[None, :, None] * t
    c = x.clone()
    c[:, 1:] += s[:, :-1]
    return c.to(base.dtype)


def prefix_propagate_dense_torch(base: torch.Tensor) -> torch.Tensor:
    """Unbatched :func:`prefix_propagate_dense_torch_batched`: ``[b, d]``."""
    return prefix_propagate_dense_torch_batched(base[None])[0]
