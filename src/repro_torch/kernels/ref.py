"""Reference oracles for the masked prefix-propagation primitive.

The primitive solves the paper's Eq. 1 in batched matrix form: given per-event
injection rows ``base`` [b, d] and a strictly-lower-triangular adjacency
``mask`` [b, b],

    c[i] = base[i] + sum_{j < i} mask[i, j] * c[j]

i.e. ``(I - L) C = B`` with unit diagonal.  ``d`` is the snapshot-basis width
for HAMLET's shared propagation (coefficient rows), or the number of parallel
per-query channels for non-shared GRETA propagation.

Three families live here:

* the numpy host oracles (``numpy_*`` / ``*_np``) — the ``"np"`` backend of
  :mod:`repro_torch.kernels.ops`, kept operation for operation as the JAX
  package has them;
* their plain PyTorch twins (``torch_*`` / ``*_torch``) — the ``"torch"``
  backend on any device, and the plain versions the hand-written CUDA
  kernels (``hamlet_propagate.py``, ``hamlet_dense.py``) are held against.
  Each torch twin repeats its numpy oracle's arithmetic (same formulation,
  same operation order where torch allows), so on the CPU the two agree
  bitwise wherever the values are exact and to rounding elsewhere;
* the twins of the JAX package's ``jnp`` oracles
  (``masked_prefix_propagate_ref`` / ``_solve`` / ``_blocked`` and
  :func:`prefix_propagate_dense_f32`) — the ``"torch_ref"``,
  ``"torch_solve"`` and ``"torch_blocked"`` backends and the lowering
  proofs' pane step (``repro_torch.launch.dryrun.hamlet_pane_step``).
  They take any leading batch dims (``[..., b, d]``, the reference's
  ``vmap``).
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
    "masked_prefix_propagate_ref",
    "masked_prefix_propagate_solve",
    "masked_prefix_propagate_blocked",
    "prefix_propagate_dense_f32",
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


# --------------------------------------------------------------------------
# twins of the JAX package's jnp oracles (the pane step's arithmetic)
# --------------------------------------------------------------------------


def _strict_lower(mask: torch.Tensor, dtype) -> torch.Tensor:
    return torch.tril(mask, diagonal=-1).to(dtype)


def masked_prefix_propagate_ref(base: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
    """Twin of the reference's ``lax.scan`` oracle over rows: row ``i`` is
    ``base[i] + mask_row_i @ c`` with the whole strictly-lower mask row
    against ``c``, whose rows ``>= i`` are still zero (so a zero entry
    against an infinite row gives NaN exactly where the reference does).
    ``base [..., b, d]``; float or integer dtypes."""
    b = base.shape[-2]
    m = _strict_lower(mask, base.dtype)
    rows = []
    for i in range(b):
        done = torch.cat(rows, dim=-2) if rows else base[..., :0, :]
        c = torch.cat([done, torch.zeros_like(base[..., i:, :])], dim=-2)
        rows.append(base[..., i:i + 1, :] + m[..., i:i + 1, :] @ c)
    return torch.cat(rows, dim=-2)


def masked_prefix_propagate_solve(base: torch.Tensor,
                                  mask: torch.Tensor) -> torch.Tensor:
    """Twin of the reference's float-only oracle: the unit-lower-triangular
    solve of ``(I - L) C = B``."""
    b = base.shape[-2]
    a = (torch.eye(b, dtype=base.dtype, device=base.device)
         - _strict_lower(mask, base.dtype))
    return torch.linalg.solve_triangular(a, base, upper=False,
                                         unitriangular=True)


def masked_prefix_propagate_blocked(base: torch.Tensor, mask: torch.Tensor,
                                    tile: int = 128) -> torch.Tensor:
    """Twin of the reference's blocked Neumann solve (the Pallas kernel's
    algorithm): row tiles solved by doubling, ``log2(tile)`` matmuls each,
    the cross-tile contributions as ``[tile, b] x [b, d]`` products
    against the rows solved so far (zeros below them, as the reference's
    ``dynamic_update_slice`` leaves them).  ``b % tile == 0``."""
    b = base.shape[-2]
    if b % tile:
        raise ValueError(f"b = {b} is not a multiple of tile = {tile}")
    m = _strict_lower(mask, base.dtype)
    n_iters = max(1, math.ceil(math.log2(tile)))
    done: list = []
    for r in range(b // tile):
        sl = slice(r * tile, (r + 1) * tile)
        c = torch.cat([*done, torch.zeros_like(base[..., r * tile:, :])],
                      dim=-2)
        stripe = m[..., sl, :]
        x = base[..., sl, :] + stripe @ c
        P = stripe[..., :, sl]
        for it in range(n_iters):
            x = x + P @ x
            if it + 1 < n_iters:
                P = P @ P
        done.append(x)
    return torch.cat(done, dim=-2)


_F32_TINY = 2.0 ** -126     # the least normal float32
_SCAN_BLOCK = 16            # XLA's CPU cumsum: 16-element blocks


def _ftz(t: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values flushed to a zero of their sign, as XLA's
    CPU and TPU arithmetic flushes them."""
    return torch.where(t.abs() < _F32_TINY, t * 0, t)


def _seq_scan(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sum along ``dim``, one float32 add a step."""
    out = [v.select(dim, 0)]
    for k in range(1, v.shape[dim]):
        out.append(_ftz(out[-1] + v.select(dim, k)))
    return torch.stack(out, dim=dim)


def _xla_cumsum(v: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(v, axis=-2)`` for float32 ``v [..., n, d]`` in the
    order XLA's CPU compiler sums it: ``n`` zero-padded to 16-element
    blocks, each block scanned in sequence, and each block's total carried
    in: the totals' exclusive prefix in sequence for at most 16 blocks,
    else the totals scanned by the same rule and shifted by one."""
    n, B = v.shape[-2], _SCAN_BLOCK
    if n <= B:
        return _seq_scan(v, -2)
    nb = -(-n // B)
    pad = torch.zeros_like(v[..., :nb * B - n, :])
    blocks = torch.cat([v, pad], dim=-2).unflatten(-2, (nb, B))
    inner = _seq_scan(blocks, -2)                      # [..., nb, B, d]
    totals = inner[..., B - 1, :]                      # [..., nb, d]
    zero = torch.zeros_like(totals[..., :1, :])
    if nb <= B:
        carry = _seq_scan(torch.cat([zero, totals[..., :-1, :]], dim=-2),
                          -2)
    else:
        carry = torch.cat([zero, _xla_cumsum(totals)[..., :-1, :]], dim=-2)
    out = _ftz(inner + carry[..., None, :])
    return out.flatten(-3, -2)[..., :n, :]


def prefix_propagate_dense_f32(base: torch.Tensor) -> torch.Tensor:
    """Twin of the reference's ``jnp`` dense closed form (its pane step's),
    float32 as the reference computes it on its own platforms: the weights
    ``2^-i`` and ``2^i`` in float32 with subnormals flushed (``2^-i`` is 0
    for i >= 127, ``2^i`` is inf for i >= 128), every product and sum
    flushed likewise, the cumsum in XLA's CPU order (:func:`_xla_cumsum`).
    So it equals the reference bitwise, NaN and inf included, where the
    float64 oracle (:func:`prefix_propagate_dense_np`) stays finite past
    row 127; the difference is the reference's, pinned in ROADMAP.md.
    ``base [..., b, d]`` float32."""
    b = base.shape[-2]
    i = np.arange(b)
    down = np.where(i < 127, np.ldexp(1.0, -i), 0.0).astype(np.float32)
    with np.errstate(over="ignore"):
        up = np.ldexp(np.float32(1.0), i).astype(np.float32)
    down, up = (torch.as_tensor(w, device=base.device)[:, None]
                for w in (down, up))
    x = _ftz(base)                  # subnormal operands count as zero
    t = _xla_cumsum(_ftz(down * x))
    s = _ftz(up * t)
    return torch.cat([base[..., :1, :], _ftz(x[..., 1:, :] + s[..., :-1, :])],
                     dim=-2)
