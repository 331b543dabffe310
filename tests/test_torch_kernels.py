"""The port's plain kernel versions against the JAX package's oracles.

``repro_torch.kernels.ref`` holds the plain PyTorch twins of the numpy
oracles; they are the ``"torch"`` backend and the versions the hand-written
CUDA kernels are held against on the card (``chip_smoke.py``).  Here, on the
CPU, the same numpy-seeded inputs go through ``repro.kernels.ref`` and the
Pallas kernels in interpret mode (as ``tests/test_kernels.py`` runs them)
and through the port:

* f64 with 0/1 masks and 0/1 injections is exact (integer counts below
  2^53), so those comparisons are bitwise;
* f32 agrees to the relative tolerance ``test_kernels.py`` uses (5e-4 for
  the masked solve, 1e-5 on the finite part of the dense closed form);
* int32 is exact, wraparound included;
* the saturation regime yields the same inf/NaN positions as the oracle of
  the same formulation.

The kernel wrappers take their plain version for a CPU tensor; that path is
covered here, the CUDA launch only on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.hamlet_dense import dense_propagate_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.hamlet_dense import (DENSE_B_MAX,
                                              dense_propagate_cuda,
                                              dense_propagate_work)
from repro_torch.kernels.hamlet_propagate import masked_prefix_propagate_cuda


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _relerr(a, b):
    return np.max(np.abs(a - b) / (1.0 + np.abs(b))) if a.size else 0.0


def _same_nonfinite(a, b):
    return all(np.array_equal(f(a), f(b))
               for f in (np.isnan, np.isposinf, np.isneginf))


def _zero_one(rng, nb, b, d, density):
    mask = np.tril(rng.random((nb, b, b)) < density, k=-1).astype(np.float64)
    base = rng.integers(0, 2, (nb, b, d)).astype(np.float64)
    return base, mask


@pytest.mark.parametrize("b,d", [(1, 1), (2, 3), (7, 3), (24, 2), (25, 2),
                                 (50, 4)])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_forward_substitution_exact_f64(b, d, density):
    rng = np.random.default_rng(b * 100 + d)
    base, mask = _zero_one(rng, 3, b, d, density)
    want = np.stack([rref.numpy_prefix_propagate(base[i], mask[i])
                     for i in range(3)])
    got = ref.torch_prefix_propagate_batched(_t(base), _t(mask)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        ref.torch_prefix_propagate(_t(base[0]), _t(mask[0])).numpy(), want[0])
    assert np.array_equal(
        rref.numpy_prefix_propagate_batched(base, mask), want)


@pytest.mark.parametrize("b,d", [(2, 1), (3, 2), (33, 3), (50, 2)])
@pytest.mark.parametrize("density", [0.3, 1.0])
def test_doubling_exact_f64(b, d, density):
    rng = np.random.default_rng(b + d)
    base, mask = _zero_one(rng, 2, b, d, density)
    want = rref.numpy_prefix_propagate_fast_batched(base, mask)
    got = ref.torch_prefix_propagate_fast_batched(_t(base), _t(mask)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        ref.torch_prefix_propagate_fast(_t(base[0]), _t(mask[0])).numpy(),
        rref.numpy_prefix_propagate_fast(base[0], mask[0]))


@pytest.mark.parametrize("b,d", [(7, 3), (64, 2), (130, 5)])
def test_f32_matches_pallas_and_oracle(b, d):
    rng = np.random.default_rng(b * 7 + d)
    mask = np.tril(rng.random((2, b, b)) < 0.3, k=-1).astype(np.float32)
    if b > 100:
        # keep magnitudes bounded (0/1 counts grow like 2^b and saturate f32)
        mask *= rng.uniform(0.0, 0.02, (2, b, b)).astype(np.float32)
    base = rng.standard_normal((2, b, d)).astype(np.float32)
    want = np.stack([rref.numpy_prefix_propagate(base[i].astype(np.float64),
                                                 mask[i].astype(np.float64))
                     for i in range(2)])
    pallas = np.asarray(rops.propagate_batched(base, mask, backend="pallas"),
                        dtype=np.float64)
    got = ref.torch_prefix_propagate_batched(_t(base), _t(mask)).double()
    assert _relerr(got.numpy(), want) < 5e-4
    assert _relerr(got.numpy(), pallas) < 5e-4


@pytest.mark.parametrize("b", [5, 130])
def test_int32_exact_with_wraparound(b):
    rng = np.random.default_rng(b)
    mask = np.tril(rng.random((2, b, b)) < 0.2, k=-1).astype(np.int32)
    base = rng.integers(0, 3, (2, b, 2)).astype(np.int32)
    want = np.stack([rref.numpy_prefix_propagate(base[i], mask[i])
                     for i in range(2)])
    got = ref.torch_prefix_propagate_batched(_t(base), _t(mask))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    pallas = np.asarray(rops.propagate_batched(base, mask, backend="pallas"))
    assert np.array_equal(got.numpy(), pallas)
    if b == 130:
        # deep enough that int32 really wrapped
        assert np.abs(want.astype(np.int64)).max() > 2 ** 20


def test_linear_in_base():
    rng = np.random.default_rng(3)
    for b, d in [(1, 1), (9, 2), (40, 3), (50, 6)]:
        mask = np.tril(rng.random((1, b, b)) < 0.4, k=-1).astype(np.float64)
        b1 = rng.standard_normal((1, b, d))
        b2 = rng.standard_normal((1, b, d))
        for fn in (ref.torch_prefix_propagate_batched,
                   ref.torch_prefix_propagate_fast_batched):
            c1, c2, c12 = (fn(_t(x), _t(mask)).numpy()
                           for x in (b1, b2, 2.0 * b1 + 3.0 * b2))
            assert np.allclose(c12, 2.0 * c1 + 3.0 * c2)


def test_doubling_closed_form():
    # fully-connected graphlet: counts double (paper Table 3: x, 2x, 4x, ...)
    b = 10
    mask = torch.tril(torch.ones(1, b, b, dtype=torch.float64), diagonal=-1)
    base = torch.ones(1, b, 1, dtype=torch.float64)
    want = 2.0 ** np.arange(b)
    for fn in (ref.torch_prefix_propagate_batched,
               ref.torch_prefix_propagate_fast_batched):
        assert np.array_equal(fn(base, mask)[0, :, 0].numpy(), want)
    dense = ref.prefix_propagate_dense_torch_batched(base)[0, :, 0].numpy()
    assert np.array_equal(dense, want)


def test_upper_triangle_and_diagonal_ignored():
    rng = np.random.default_rng(1)
    b = 33
    full = rng.random((2, b, b))
    base = rng.standard_normal((2, b, 2))
    tril = np.tril(full, k=-1)
    for fn in (ref.torch_prefix_propagate_batched,
               ref.torch_prefix_propagate_fast_batched,
               masked_prefix_propagate_cuda):
        assert torch.equal(fn(_t(base), _t(full)), fn(_t(base), _t(tril)))


@pytest.mark.parametrize("b,d", [(1, 1), (2, 3), (17, 4), (63, 2), (200, 8),
                                 (512, 2)])
def test_dense_closed_form(b, d):
    """Bitwise the numpy closed form; equal to the masked all-ones solve."""
    rng = np.random.default_rng(b)
    base = rng.random((2, b, d)) * 0.001
    want = rref.prefix_propagate_dense_np_batched(base)
    got = ref.prefix_propagate_dense_torch_batched(_t(base)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(
        ref.prefix_propagate_dense_torch(_t(base[0])).numpy(),
        rref.prefix_propagate_dense_np(base[0]))
    mask = np.tril(np.ones((b, b)), k=-1)
    solved = rref.numpy_prefix_propagate_fast(base[0], mask)
    assert _relerr(got[0], solved) < 1e-9


@pytest.mark.parametrize("b,d", [(64, 1), (128, 8), (256, 5)])
def test_dense_f32_matches_pallas(b, d):
    """f32: the saturation positions of the Pallas kernel (interpret mode),
    and its values to 1e-5 on the finite part (tests/test_kernels.py)."""
    rng = np.random.default_rng(b + d)
    base = (rng.random((2, b, d)) * 1e-4).astype(np.float32)
    pallas = np.asarray(dense_propagate_pallas(jnp.asarray(base)))
    got = ref.prefix_propagate_dense_torch_batched(_t(base)).numpy()
    assert got.dtype == np.float32
    fin = np.isfinite(pallas)
    assert np.array_equal(fin, np.isfinite(got))
    rel = np.max(np.abs(got[fin] - pallas[fin]) / (1e-30 + np.abs(pallas[fin])))
    assert rel < 1e-5, rel


def test_saturation_pattern_1100_chain():
    """The overflow chain: each formulation saturates exactly like its
    numpy oracle — forward substitution to +inf from row 1024, Neumann
    doubling to NaN everywhere (0 * inf in the squared adjacency)."""
    b = 1100
    mask = np.tril(np.ones((1, b, b)), k=-1)
    base = np.ones((1, b, 2))
    with np.errstate(over="ignore", invalid="ignore"):
        want_fs = rref.numpy_prefix_propagate(base[0], mask[0])
        want_fast = rref.numpy_prefix_propagate_fast_batched(base, mask)
    got_fs = ref.torch_prefix_propagate_batched(_t(base), _t(mask)).numpy()[0]
    got_fast = ref.torch_prefix_propagate_fast_batched(_t(base),
                                                       _t(mask)).numpy()
    assert np.isposinf(want_fs).sum() == 2 * (b - 1024)
    assert _same_nonfinite(got_fs, want_fs)
    assert np.array_equal(got_fs[np.isfinite(want_fs)],
                          want_fs[np.isfinite(want_fs)])
    assert np.isnan(want_fast).all() and _same_nonfinite(got_fast, want_fast)


def test_dense_saturation_pattern():
    rng = np.random.default_rng(5)
    base = rng.random((3, 512, 2)) * 1e170       # overflows f64 mid-burst
    base[1, 300:310] = np.inf
    base[2, 200, 1] = np.nan
    with np.errstate(over="ignore", invalid="ignore"):
        want = rref.prefix_propagate_dense_np_batched(base)
    got = ref.prefix_propagate_dense_torch_batched(_t(base)).numpy()
    assert not np.isfinite(want).all() and np.isfinite(want).any()
    assert _same_nonfinite(got, want)
    fin = np.isfinite(want)
    assert np.array_equal(got[fin], want[fin])


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    base, mask = _zero_one(rng, 4, 40, 3, 0.5)
    n0 = masked_prefix_propagate_cuda.launches
    got = masked_prefix_propagate_cuda(_t(base), _t(mask))
    assert torch.equal(got, ref.torch_prefix_propagate_batched(_t(base),
                                                                _t(mask)))
    d0 = dense_propagate_cuda.launches
    assert torch.equal(dense_propagate_cuda(_t(base)),
                       ref.prefix_propagate_dense_torch_batched(_t(base)))
    # the plain path is not a kernel launch
    assert masked_prefix_propagate_cuda.launches == n0
    assert dense_propagate_cuda.launches == d0


def test_shape_counters_untouched_on_cpu():
    """Only a kernel launch counts a shape: the plain path on a CPU tensor
    leaves both wrappers' ``shapes`` Counters as they were."""
    rng = np.random.default_rng(4)
    base, mask = _zero_one(rng, 3, 20, 2, 0.5)
    masked0 = masked_prefix_propagate_cuda.shapes.copy()
    dense0 = dense_propagate_cuda.shapes.copy()
    masked_prefix_propagate_cuda(_t(base), _t(mask))
    dense_propagate_cuda(_t(base))
    dense_propagate_cuda(_t(base).float())
    assert masked_prefix_propagate_cuda.shapes == masked0
    assert dense_propagate_cuda.shapes == dense0


@pytest.mark.parametrize("bad", ["shape", "dtype", "mixed", "device", "2d"])
def test_masked_wrapper_rejects(bad):
    base = torch.zeros(2, 5, 3, dtype=torch.float64)
    mask = torch.zeros(2, 5, 5, dtype=torch.float64)
    if bad == "shape":
        mask = torch.zeros(2, 5, 4, dtype=torch.float64)
    elif bad == "dtype":
        base, mask = base.to(torch.int64), mask.to(torch.int64)
    elif bad == "mixed":
        mask = mask.to(torch.float32)
    elif bad == "device":
        base, mask = base.to("meta"), mask.to("meta")
    else:
        base = base[0]
    with pytest.raises((ValueError, TypeError)):
        masked_prefix_propagate_cuda(base, mask)


@pytest.mark.parametrize("bad", ["dtype", "device", "2d", "b513"])
def test_dense_wrapper_rejects(bad):
    base = torch.zeros(2, 5, 3, dtype=torch.float64)
    if bad == "dtype":
        base = base.to(torch.int32)
    elif bad == "device":
        base = base.to("meta")
    elif bad == "b513":
        # past the cap even on a CPU tensor, whose plain version's 2^{+-i}
        # weights leave the f64 range from i = 1024 on
        base = torch.zeros(2, DENSE_B_MAX + 1, 3, dtype=torch.float64)
    else:
        base = base[0]
    with pytest.raises((ValueError, TypeError)):
        dense_propagate_cuda(base)


@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("b", [1, 15, 16, 17, 512])
def test_dense_chip_shapes_match_oracle(b, d):
    """The lane edges of the CUDA kernel's fixed 16-row runs and the 512
    cap, at every column chunking (d 1, 3, 5): the plain version, and the
    wrapper on the CPU, bitwise against the numpy closed form of the JAX
    package on non-integer f64 inputs."""
    rng = np.random.default_rng(b * 10 + d)
    base = rng.random((3, b, d)) * 3.0
    want = rref.prefix_propagate_dense_np_batched(base)
    assert np.isfinite(want).all()
    assert np.array_equal(
        ref.prefix_propagate_dense_torch_batched(_t(base)).numpy(), want)
    assert np.array_equal(dense_propagate_cuda(_t(base)).numpy(), want)


@pytest.mark.parametrize("d", [1, 3, 5])
def test_dense_chip_shapes_f32_match_pallas(d):
    """f32 at the cap (b = 512, a multiple of the Pallas kernel's 64-row
    tile): the saturation positions of the Pallas kernel (interpret mode)
    and its values to 1e-5 on the finite part."""
    rng = np.random.default_rng(500 + d)
    base = (rng.random((2, DENSE_B_MAX, d)) * 1e-4).astype(np.float32)
    pallas = np.asarray(dense_propagate_pallas(jnp.asarray(base)))
    got = dense_propagate_cuda(_t(base)).numpy()
    assert got.dtype == np.float32
    fin = np.isfinite(pallas)
    assert np.array_equal(fin, np.isfinite(got)) and fin.any()
    rel = np.max(np.abs(got[fin] - pallas[fin]) / (1e-30 + np.abs(pallas[fin])))
    assert rel < 1e-5, rel


@pytest.mark.parametrize("b", [1, 15, 17, 100, 300])
def test_dense_prefix_invariant_under_zero_padding(b):
    """A burst alone, and zero-padded after its rows to next_pow2(b) (as
    the executor buckets it) and to the cap: the real rows are bitwise
    the same, in the plain version and in the numpy oracle."""
    rng = np.random.default_rng(b)
    burst = rng.random((2, b, 2)) * 3.0
    alone = ref.prefix_propagate_dense_torch_batched(_t(burst)).numpy()
    for bp in (1 << (b - 1).bit_length(), DENSE_B_MAX):
        padded = np.zeros((2, bp, 2))
        padded[:, :b] = burst
        got = ref.prefix_propagate_dense_torch_batched(_t(padded)).numpy()
        assert np.array_equal(got[:, :b], alone)
        assert np.array_equal(
            rref.prefix_propagate_dense_np_batched(padded)[:, :b], alone)


@pytest.mark.parametrize("nb,b,d,itemsize", [(1, 1, 1, 8), (485, 512, 2, 8),
                                             (3, 17, 5, 4)])
def test_dense_propagate_work_hand_count(nb, b, d, itemsize):
    """The roofline work of the dense kernel: base read and out written
    once, three operations (c = b + s, s = 2 s + b) per element."""
    want_bytes = sum(2 * itemsize for _ in range(nb * b * d))
    assert dense_propagate_work(nb, b, d, itemsize) == (want_bytes,
                                                        3.0 * nb * b * d)


@pytest.mark.parametrize("nb,b,d,itemsize", [(1, 1, 1, 8), (2, 3, 2, 8),
                                             (1, 5, 1, 4), (3, 33, 5, 8),
                                             (2, 64, 3, 4)])
def test_masked_propagate_work_hand_count(nb, b, d, itemsize):
    """The roofline work of the masked kernel, counted entry by entry: base
    read and out written once, each strict-lower mask entry read once and
    used for one multiply and one add per column."""
    from repro_torch.kernels.hamlet_propagate import masked_propagate_work

    lower = sum(1 for _ in range(nb) for i in range(b) for j in range(i))
    want_bytes = itemsize * (nb * b * d + nb * b * d + lower)
    want_ops = sum(2 for _ in range(lower) for _c in range(d))
    assert masked_propagate_work(nb, b, d, itemsize) == (want_bytes, want_ops)


def _chip_shape_case(seed, nb, b, d):
    rng = np.random.default_rng(seed)
    mask = np.tril(rng.random((nb, b, b)) < 0.5, k=-1).astype(np.float64)
    base = rng.integers(0, 2, (nb, b, d)).astype(np.float64)
    return base, mask


@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("b", [1, 31, 32, 33, 64, 65])
def test_masked_chip_shapes_match_pallas_and_oracle(b, d):
    """The tile and lookahead edges of the CUDA kernel (b around 32 and 64)
    at every column chunking (d 1, 3, 5): the plain version, and the wrapper
    on the CPU, against the Pallas kernel (interpret mode) and the numpy
    row oracle.  0/1 counts stay below 2^53, so the oracle is bitwise."""
    base, mask = _chip_shape_case(b * 10 + d, 2, b, d)
    want = rref.numpy_prefix_propagate_batched(base, mask)
    pallas = np.asarray(rops.propagate_batched(base, mask, backend="pallas"))
    got = ref.torch_prefix_propagate_batched(_t(base), _t(mask)).numpy()
    assert np.array_equal(got, want)
    assert _relerr(got, pallas) < 1e-12
    assert np.array_equal(
        masked_prefix_propagate_cuda(_t(base), _t(mask)).numpy(), want)


@pytest.mark.parametrize("nb,b,d", [(200, 33, 2), (2, 313, 2)])
def test_masked_many_blocks_and_odd_b(nb, b, d):
    """More batch elements than the card has SMs, and an odd b (rows only
    8-byte aligned on the card): plain version against the row oracle, to
    1e-12 (at b = 313 the counts pass 2^53, so the order of addition
    shows)."""
    base, mask = _chip_shape_case(nb + b, nb, b, d)
    want = rref.numpy_prefix_propagate_batched(base, mask)
    got = ref.torch_prefix_propagate_batched(_t(base), _t(mask)).numpy()
    assert np.isfinite(want).all() and _relerr(got, want) < 1e-12


@pytest.mark.parametrize("b,d", [(33, 1), (65, 3), (40, 5)])
def test_nan_on_and_above_the_diagonal_never_reaches_the_output(b, d):
    """NaN written on the diagonal and in the upper triangle: the plain
    version (and the wrapper on the CPU) give bitwise the row oracle's
    result on the clean strictly lower mask, with no NaN, and the Pallas
    kernel agrees on the clean mask."""
    base, clean = _chip_shape_case(b + d, 2, b, d)
    dirty = clean.copy()
    dirty[np.triu(np.ones((2, b, b), dtype=bool))] = np.nan
    want = rref.numpy_prefix_propagate_batched(base, clean)
    pallas = np.asarray(rops.propagate_batched(base, clean, backend="pallas"))
    for fn in (ref.torch_prefix_propagate_batched,
               masked_prefix_propagate_cuda):
        got = fn(_t(base), _t(dirty)).numpy()
        assert not np.isnan(got).any()
        assert np.array_equal(got, want)
        assert _relerr(got, pallas) < 1e-12
