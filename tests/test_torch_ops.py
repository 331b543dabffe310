"""The port's ``kernels/ops.py`` against ``repro.kernels.ops``.

Dispatch, raggedness, ``nb == 0``, the dense size cap and the two fold
programs (``fold_stacked``, ``fold_rounds_scan``) are held against the JAX
package on the same numpy-seeded inputs: the port's ``np`` backend bitwise,
its ``torch`` backend on the CPU bitwise where the values are exact and to
1e-12 relative elsewhere, with the same inf/NaN pattern on overflowed
operands (twins of ``tests/test_fold_scan.py``'s kernel-level tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.kernels import hamlet_dense, ops

BACKENDS = [("np", None), ("torch", "cpu")]


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_nonfinite(a, b):
    return all(np.array_equal(f(a), f(b))
               for f in (np.isnan, np.isposinf, np.isneginf))


@pytest.mark.parametrize("backend,device", BACKENDS)
@pytest.mark.parametrize("b", [3, 24, 25, 60])
def test_propagate_batched_matches_reference(backend, device, b):
    rng = np.random.default_rng(b)
    mask = np.tril(rng.random((4, b, b)) < 0.4, k=-1).astype(np.float64)
    base = rng.integers(0, 2, (4, b, 3)).astype(np.float64)
    want = rops.propagate_batched(base, mask, backend="np")
    got = _host(ops.propagate_batched(base, mask, backend=backend,
                                      device=device))
    assert np.array_equal(got, want)
    one = _host(ops.propagate(base[1], mask[1], backend=backend,
                              device=device))
    assert np.array_equal(one, rops.propagate(base[1], mask[1], backend="np"))


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_ragged_padding_leaves_real_rows(backend, device):
    """Zero-padded trailing rows/columns never perturb the real region."""
    rng = np.random.default_rng(11)
    b, pad = 30, 9
    mask = np.tril(rng.random((2, b, b)) < 0.5, k=-1).astype(np.float64)
    base = rng.integers(0, 2, (2, b, 2)).astype(np.float64)
    pm = np.zeros((2, b + pad, b + pad))
    pm[:, :b, :b] = mask
    pb = np.zeros((2, b + pad, 2))
    pb[:, :b] = base
    got = _host(ops.propagate_batched(pb, pm, backend=backend, device=device))
    assert np.array_equal(got[:, :b], _host(ops.propagate_batched(
        base, mask, backend=backend, device=device)))
    assert not got[:, b:].any()
    dense = _host(ops.propagate_dense_batched(pb, backend=backend,
                                              device=device))
    assert np.array_equal(dense[:, :b], rops.propagate_dense_batched(
        base, backend="np"))


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_empty_batch(backend, device):
    for fn, args in ((ops.propagate_batched, (np.zeros((0, 5, 2)),
                                              np.zeros((0, 5, 5)))),
                     (ops.propagate_dense_batched, (np.zeros((0, 5, 2)),))):
        out = fn(*args, backend=backend, device=device)
        assert tuple(out.shape) == (0, 5, 2)
        assert _host(out).dtype == np.float64


@pytest.mark.parametrize("backend,device", BACKENDS)
def test_dense_cap_and_fallback(backend, device):
    # one constant: the kernel wrapper's cap is the one ops routes by
    assert ops.DENSE_B_MAX is hamlet_dense.DENSE_B_MAX
    assert ops.DENSE_B_MAX == rops.DENSE_B_MAX == 512
    with pytest.raises(ValueError):
        ops.propagate_dense_batched(np.zeros((1, 513, 1)), backend=backend,
                                    device=device)
    rng = np.random.default_rng(4)
    big = rng.random((520, 2)) * 1e-3
    want = rops.propagate_dense(big, backend="np")     # masked fallback
    got = _host(ops.propagate_dense(big, backend=backend, device=device))
    assert np.allclose(got, want, rtol=1e-12)
    small = rng.random((200, 2))
    assert np.array_equal(
        _host(ops.propagate_dense(small, backend=backend, device=device)),
        rops.propagate_dense(small, backend="np"))


def test_device_get_all():
    a = np.arange(6.0).reshape(2, 3)
    assert ops.device_get_all([]) == []
    out = ops.device_get_all([a, torch.ones(2, 2, dtype=torch.float64)])
    assert out[0] is a
    assert isinstance(out[1], np.ndarray) and out[1].sum() == 4.0


def test_resolve_device():
    assert ops.resolve_device("np", "cuda:3") is None
    assert ops.resolve_device("torch", "cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        ops.resolve_device("pallas")
    with pytest.raises(ValueError):
        ops.resolve_device("cuda", "cpu")
    if not torch.cuda.is_available():
        for backend in ("cuda", "torch"):
            with pytest.raises(RuntimeError):
                ops.resolve_device(backend)


# ---------------------------------------------------------------- fold_stacked


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("backend,device", BACKENDS)
def test_fold_stacked_matches_reference(backend, device, overflow):
    rng = np.random.default_rng(7)
    N, n, C = 5, 6, 4
    u0 = rng.standard_normal((N, C))
    Ms = rng.standard_normal((N, n, C, C))
    if overflow:
        Ms *= 1e160                        # chains overflow f64 mid-fold
    with np.errstate(over="ignore", invalid="ignore"):
        want = rops.fold_stacked(u0, Ms, backend="np")
    jx = np.asarray(rops.fold_stacked(u0, Ms, backend="jax"))
    got = _host(ops.fold_stacked(u0, Ms, backend=backend, device=device))
    fin = np.isfinite(want)
    if overflow:
        assert not fin.all()
    for other in (want, jx):
        assert _same_nonfinite(got, other)
        np.testing.assert_allclose(got[fin], other[fin], rtol=1e-12)
    if backend == "np":
        assert np.array_equal(got[fin], want[fin])


def test_fold_stacked_zero_length_chain():
    u0 = np.ones((3, 4))
    Ms = np.zeros((3, 0, 4, 4))
    assert np.array_equal(_host(ops.fold_stacked(u0, Ms, backend="torch",
                                                 device="cpu")), u0)


# ------------------------------------------------------------ fold_rounds_scan


def _scan_operands(rng, overflow):
    """A random scan program: J*k state blocks of R rows, ``rounds`` rounds
    of NMAX lanes, the last lanes of each round padded to the scratch row;
    real scatter targets are distinct within a round (as fold_exec builds
    them).  Values are non-negative, as the engine's counts are, so
    overflow saturates to +inf in any summation order and NaN comes only
    from 0 * inf."""
    nu, t, n_used, C = 2, 3, 2, 5
    R = 1 + nu * t + nu
    blocks, rounds, nmax = 4, 3, 3
    scratch = blocks * R
    Z0 = rng.integers(0, 3, (scratch + 1, C)).astype(np.float64)
    Z0[scratch] = 0.0
    G = rounds * nmax
    S = rng.integers(0, 3, (G * n_used + 1, 1 + nu)).astype(np.float64)
    S[-1] = 0.0
    if overflow:
        S[:-1] *= 1e200
    PTM = rng.integers(0, 2, (rounds, nmax, t)).astype(np.float64)
    GQ = np.full((rounds, nmax, R), scratch, dtype=np.int64)
    SIDX = np.full((rounds, nmax, n_used), G * n_used, dtype=np.int64)
    SC = np.full((rounds, nmax * n_used), scratch, dtype=np.int64)
    ER = np.full((rounds, nmax * n_used), scratch, dtype=np.int64)
    for r in range(rounds):
        live = nmax - (r % 2)                   # ragged rounds: padded lanes
        blk = rng.permutation(blocks)[:live]
        GQ[r, :live] = blk[:, None] * R + np.arange(R)
        SIDX[r, :live] = (r * nmax + np.arange(live))[:, None] * n_used \
            + np.arange(n_used)
        rows = (blk[:, None] * R + 1 + np.arange(n_used)[None] * t
                + rng.integers(0, t, (live, 1))).ravel()
        SC[r, :live * n_used] = rows
        ER[r, :live * n_used] = (blk[:, None] * R + 1 + nu * t
                                 + np.arange(n_used)[None]).ravel()
    return Z0, S, PTM, GQ, SIDX, SC, ER, dict(nu=nu, t=t, n_used=n_used)


@pytest.mark.parametrize("overflow", [False, True])
def test_fold_rounds_scan_matches_reference(overflow):
    rng = np.random.default_rng(21 + overflow)
    Z0, S, PTM, GQ, SIDX, SC, ER, kw = _scan_operands(rng, overflow)
    want = np.asarray(rops.fold_rounds_scan(
        jnp.asarray(Z0), jnp.asarray(S), jnp.asarray(PTM),
        jnp.asarray(GQ, jnp.int32), jnp.asarray(SIDX, jnp.int32),
        jnp.asarray(SC, jnp.int32), jnp.asarray(ER, jnp.int32), **kw))
    t = torch.as_tensor
    Z0t = t(Z0)
    got = ops.fold_rounds_scan(Z0t, S, t(PTM), t(GQ), t(SIDX), t(SC), t(ER),
                               **kw).numpy()
    assert np.array_equal(Z0t.numpy(), Z0)          # input state untouched
    real = slice(0, Z0.shape[0] - 1)               # the scratch row is junk
    if overflow:
        assert not np.isfinite(want[real]).all()
    assert _same_nonfinite(got[real], want[real])
    fin = np.isfinite(want[real])
    np.testing.assert_allclose(got[real][fin], want[real][fin], rtol=1e-12)
