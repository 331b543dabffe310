"""Public wrappers around the propagation primitive and the fold programs.

``propagate(base, mask, backend=...)`` dispatches to one of these backends:

* ``"np"``    — the numpy host oracles of :mod:`.ref` (host arrays in and out);
* ``"torch"`` — their plain PyTorch twins on any ``torch.device``;
* ``"cuda"``  — the hand-written CUDA kernels (``hamlet_propagate.py``,
  ``hamlet_dense.py``) on a CUDA device;
* ``"torch_ref"``, ``"torch_blocked"``, ``"torch_solve"`` — the twins of
  the JAX package's ``jnp`` oracles (its ``"jax"``, ``"jax_blocked"`` and
  ``"jax_solve"`` backends) on any ``torch.device``: the row scan, the
  blocked Neumann solve and the triangular solve.

The device backends return device-resident tensors; callers launch a whole
flush and then fetch every result with **one** :func:`device_get_all` sync.
Unlike the TPU path of the JAX package, nothing is padded to 128-row tiles:
the kernels take any ``b`` and ``d``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import ref
from .hamlet_dense import DENSE_B_MAX, dense_propagate_cuda
from .hamlet_propagate import masked_prefix_propagate_cuda

__all__ = ["propagate", "propagate_batched", "propagate_dense",
           "propagate_dense_batched", "fold_stacked", "fold_rounds_scan",
           "device_get_all", "resolve_device", "on_device",
           "kernel_launches", "PROPAGATE_BACKENDS", "DENSE_B_MAX"]

PROPAGATE_BACKENDS = ("np", "torch", "cuda", "torch_ref", "torch_blocked",
                      "torch_solve")

# bursts up to this length take the row-by-row oracle on the np and torch
# backends (the doubling GEMMs win above it)
_FAST_MIN_B = 25


def resolve_device(backend: str, device=None) -> torch.device | None:
    """The device a backend runs on: ``None`` for ``"np"`` (host numpy),
    else ``device`` or, by default, ``cuda:0``.

    Raises when a CUDA device is asked for and none is present — the port
    never carries on on the CPU unless the caller asks for the CPU — and
    when the ``"cuda"`` backend is given a non-CUDA device (the plain
    versions are the ``"torch"`` backend)."""
    if backend not in PROPAGATE_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of "
                         f"{PROPAGATE_BACKENDS}")
    if backend == "np":
        return None
    dev = torch.device(device if device is not None else "cuda:0")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("backend 'cuda' runs the hand-written kernels on a "
                         f"CUDA device, got {dev}; use backend='torch' for "
                         "the plain versions")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for backend {backend!r} on {dev}; "
                           "ask for backend='torch', device='cpu' or "
                           "backend='np' to run on the host")
    return dev


def on_device(dev: torch.device | None):
    """A context that makes ``dev`` the calling thread's current CUDA
    device (a thread's current device is its own, and a kernel launches on
    it); it does nothing for the host (``None`` or a CPU device)."""
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def kernel_launches() -> dict[str, int]:
    """The hand-written kernels' launch counters in this process."""
    return {"hamlet_propagate": masked_prefix_propagate_cuda.launches,
            "hamlet_dense": dense_propagate_cuda.launches}


def _dev(backend: str, device) -> torch.device:
    return (device if isinstance(device, torch.device)
            else resolve_device(backend, device))


def propagate_batched(base, mask, *, backend: str = "np", device=None):
    """Batched propagation: base [nb, b, d], mask [nb, b, b] -> [nb, b, d].

    The batch is ragged-friendly at the edges: ``nb == 0`` returns an empty
    result, and zero-padded trailing rows (zero mask rows/columns) propagate
    to zeros without touching real rows, so callers may pad within a bucket.
    """
    if backend == "np":
        base = np.asarray(base)
        mask = np.asarray(mask)
        if base.shape[0] == 0:
            return np.zeros(base.shape, dtype=base.dtype)
        if base.shape[1] >= _FAST_MIN_B and not np.issubdtype(base.dtype,
                                                              np.integer):
            # one stacked doubling sweep — slices are bitwise equal to the
            # per-item call (see ref.numpy_prefix_propagate_fast_batched)
            return ref.numpy_prefix_propagate_fast_batched(base, mask)
        return np.stack([ref.numpy_prefix_propagate(base[i], mask[i])
                         for i in range(base.shape[0])])
    dev = _dev(backend, device)
    base = torch.as_tensor(base, device=dev)
    mask = torch.as_tensor(mask, dtype=base.dtype, device=dev)
    if base.shape[0] == 0:
        return torch.zeros_like(base)
    if backend == "cuda":
        return masked_prefix_propagate_cuda(base.contiguous(),
                                            mask.contiguous())
    if backend == "torch_ref":
        return ref.masked_prefix_propagate_ref(base, mask)
    if backend == "torch_blocked":
        b = base.shape[1]
        return ref.masked_prefix_propagate_blocked(
            base, mask, tile=128 if b % 128 == 0 else b)
    if backend == "torch_solve":
        return ref.masked_prefix_propagate_solve(base, mask)
    if base.shape[1] >= _FAST_MIN_B and base.dtype.is_floating_point:
        return ref.torch_prefix_propagate_fast_batched(base, mask)
    return ref.torch_prefix_propagate_batched(base, mask)


def propagate(base, mask, *, backend: str = "np", device=None):
    """Unbatched propagation: base [b, d], mask [b, b] -> [b, d]."""
    return propagate_batched(base[None], mask[None], backend=backend,
                             device=device)[0]


def propagate_dense_batched(base, *, backend: str = "np", device=None):
    """Batched dense-burst propagation: base [nb, b, d] -> [nb, b, d].

    One launch for a whole size bucket of dense bursts.  ``nb == 0`` returns
    an empty result; trailing zero-padded rows/columns are safe (each real
    row's prefix is unchanged), so ragged buckets pad to a common shape.
    Requires b <= DENSE_B_MAX per burst (the dense weight range) — the
    engine's planner routes larger bursts to the masked path.
    """
    nb, b, d = np.shape(base)
    if b > DENSE_B_MAX:
        raise ValueError(
            f"dense closed form needs b <= {DENSE_B_MAX}, got {b}")
    if backend == "np":
        base = np.asarray(base)
        if nb == 0:
            return np.zeros((0, b, d), dtype=base.dtype)
        return ref.prefix_propagate_dense_np_batched(base)
    base = torch.as_tensor(base, device=_dev(backend, device))
    if nb == 0:
        return torch.zeros_like(base)
    if backend == "cuda":
        return dense_propagate_cuda(base.contiguous())
    return ref.prefix_propagate_dense_torch_batched(base)


def propagate_dense(base, *, backend: str = "np", device=None):
    """Propagation for a *dense* burst (strictly-lower all-ones adjacency —
    no edge predicates, no divergent/dead rows): closed form in O(b*d).
    Falls back to the masked path for b > 512 (weight range)."""
    b = base.shape[0]
    if b > DENSE_B_MAX:
        mask = np.tril(np.ones((b, b)), k=-1)
        return propagate(base, mask, backend=backend, device=device)
    return propagate_dense_batched(base[None], backend=backend,
                                   device=device)[0]


def device_get_all(arrays: list) -> list[np.ndarray]:
    """Fetch many (possibly device-resident) arrays with **one** host sync.

    The pane-batch executor launches every bucket of a flush before pulling
    any result back, then converts the whole backlog here: every CUDA
    tensor is copied into pinned host memory asynchronously, then one
    synchronize per device waits for all the copies.  Numpy arrays and CPU
    tensors pass through without a copy.
    """
    if not arrays:
        return []
    if all(isinstance(a, np.ndarray) for a in arrays):
        return list(arrays)
    staged: list = []
    devices: set = set()
    for a in arrays:
        if isinstance(a, torch.Tensor) and a.device.type == "cuda":
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a, non_blocking=True)
            devices.add(a.device)
            staged.append(host)
        else:
            staged.append(a)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return [a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            for a in staged]


def fold_stacked(u0, Ms, *, backend: str = "np", device=None):
    """Stacked window-chain fold: ``u0 [N, C]``, ``Ms [N, n, C, C]`` ->
    ``[N, C]``.

    Slice ``i`` applies the chain ``u = u @ M.T`` over ``Ms[i, 0..n)`` in
    order — the :func:`repro_torch.core.engine.fold_panes` recurrence.  One
    call folds a whole bucket of same-length windows.  On the device
    backends the chain is ``n`` batched matmuls on the device and the
    result stays there; callers batch several buckets and resolve them with
    **one** :func:`device_get_all` sync (see ``core/fold_exec.py``).
    """
    n = np.shape(Ms)[1] if np.ndim(Ms) >= 2 else 0
    if backend == "np":
        U = np.asarray(u0)
        Ms = np.asarray(Ms)
        with np.errstate(over="ignore", invalid="ignore"):
            for j in range(n):
                U = np.matmul(U[:, None, :],
                              np.swapaxes(Ms[:, j], 1, 2))[:, 0]
        return U
    dev = _dev(backend, device)
    U = torch.as_tensor(u0, device=dev)
    Ms = torch.as_tensor(Ms, device=dev)
    for j in range(n):
        U = torch.matmul(U[:, None, :], Ms[:, j].transpose(1, 2))[:, 0]
    return U


def fold_rounds_scan(Z0, S, PTM, GQ, SIDX, SC, ER, *, nu, t, n_used):
    """A whole fold flush as one device program (see fold_exec.py).

    Executes every d == 0 fold round of a flush on the device holding the
    fused flat state ``Z0 [J*k*R + 1, C]`` (row ``J*k*R`` is a scratch row
    absorbing padded lanes); ``Z0`` is left untouched and the folded state
    is returned.  Per round: one state gather, the ``W`` build matmul, one
    ``S`` gather, the update matmul, and two scatter-adds (arow targets +
    rrow/end targets).  All index operands are int64 device tensors built
    once per flush plan:

    * ``S    [G*n_used + 1, B_local]`` — per-group column-sum rows, last
      row zeros (padded lanes); a host array, copied once per flush;
    * ``PTM  [rounds, NMAX, t]``       — pt_mask rows, padded zero;
    * ``GQ   [rounds, NMAX, R]``       — flat state gather rows (padded →
      scratch);
    * ``SIDX [rounds, NMAX, n_used]``  — rows into ``S`` (padded → zeros
      row);
    * ``SC / ER [rounds, NMAX * n_used]`` — scatter rows (padded /
      non-end → scratch).

    Within a round the real scatter targets are distinct (asserted when the
    program is built), so the atomic ``index_add_`` on CUDA adds exactly one
    term to each real row and its result does not depend on order; only the
    scratch row takes several.
    """
    C = Z0.shape[1]
    S = torch.as_tensor(S, device=Z0.device)
    Zf = Z0.clone()
    for r in range(GQ.shape[0]):
        zm = Zf[GQ[r]]                                    # [NMAX, R, C]
        Wu = torch.matmul(PTM[r][:, None, None, :],
                          zm[:, 1:1 + nu * t].reshape(-1, nu, t, C))[:, :, 0]
        W = torch.cat([zm[:, 0:1], Wu], dim=1)            # [NMAX, 1+nu, C]
        upd = torch.matmul(S[SIDX[r]], W).reshape(-1, C)
        Zf.index_add_(0, SC[r], upd)
        Zf.index_add_(0, ER[r], upd)
    return Zf
