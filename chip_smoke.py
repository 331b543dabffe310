#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; a failure in any of them exits non-zero:

1. env      — the card's name and power limit (nvidia-smi), torch and CUDA
              versions;
2. build    — builds the hand-written kernels from ``src/repro_torch/kernels
              /csrc`` (one ``nvcc`` per source, all in parallel) and prints the
              build time;
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the main path's bucket shapes and at each kernel's edges
              (masked: d 1-5, b at the 32-row tile edges, 200 blocks, NaN on
              and above the diagonal; dense: b at the 16-row lane edges and
              the 512 cap, d 1-5, nb 1 and 200, integer-valued f64 bitwise,
              +inf entries, a burst zero-padded to 128 and 256 rows bitwise
              equal to the burst alone, b = 513 refused), with the
              tolerance stated per check; ``ms`` and ``library_ms`` are
              device time per call (30 calls queued behind a spin kernel,
              CUDA events), ``plain_ms`` the time of one call of the plain
              version, host launches included (it is a loop of small torch
              ops);
4. main     — the main path, ``HamletRuntime(..., backend="cuda",
              micro_batch=16, plan_cache=True, fold_exec=True).run(...)``, on
              the ``overload_64plus_pred_full`` configuration (163,041 events),
              held against the port's numpy oracle (``backend="np"``), with
              every kernel's launch count from that run; then the same
              configuration at 1/20 of its rate, whose windows are finite,
              held the same way; then the full run under ``torch.profiler``
              for the device's busy share; then each kernel's launches by
              shape: the most frequent, the bound summed over all of them
              against the profiler's total, and every distinct shape timed
              again alone, costliest first;
5. cli      — the port's ``launch.hamlet_service`` default mode on the card,
              held against ``backend="np"``.

The last three lines of standard output are the kernels' JSON record, the
card's ``name, power.limit`` as nvidia-smi prints them, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

MAIN_CONFIG = "overload_64plus_pred_full"
RTOL_MAIN = 1e-9        # finite window values, cuda vs np (stated by the run)
RTOL_SUM = 1e-12        # SUM/AVG in the cli phase: kernels reorder sums
# the main configuration at 1/20 of its rate (8,241 events): every window
# of the full run saturates past f64, every window of this cut is finite,
# and it launches both kernels, so it holds their finite values end to end
FINITE_CUT = 1000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def wall_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Time of one call as its caller sees it, host launches included: the
    median of ``reps`` calls, each between CUDA events on an idle card."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(np, got, want) -> dict:
    """Max abs / rel error on the finite region and the non-finite pattern
    (NaN, +inf, -inf positions) of ``got`` against ``want``."""
    g = got.detach().cpu().double().numpy()
    w = want.detach().cpu().double().numpy()
    fin = np.isfinite(w) & np.isfinite(g)
    pattern = all(np.array_equal(f(g), f(w))
                  for f in (np.isnan, np.isposinf, np.isneginf))
    diff = np.abs(g[fin] - w[fin])
    return {"max_abs_err": float(diff.max()) if diff.size else 0.0,
            "max_rel_err": float((diff / (1.0 + np.abs(w[fin]))).max())
            if diff.size else 0.0,
            "nonfinite_equal": bool(pattern),
            "bitwise_equal": bool(pattern and np.array_equal(g[fin], w[fin])),
            "nonfinite": int((~np.isfinite(w)).sum())}


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_env(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"[env] card: {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.load()
    dt = time.perf_counter() - t0
    regs = [ln.strip() for ln in lib.ptxas_log.splitlines()
            if "registers" in ln]
    log(f"[build] {lib.path.name}: {dt:.2f} s (nvcc {lib.build_s:.2f} s)")
    for ln in regs:
        log(f"[build] ptxas: {ln}")
    return lib


def _masked_case(torch, np, rng, dev, nb, b, d, dtype, kind):
    if kind == "ones":
        mask = np.tril(np.ones((nb, b, b)), -1)
        base = np.ones((nb, b, d))
    elif kind == "f32":
        mask = (np.tril(rng.random((nb, b, b)) < 0.3, -1)
                * rng.uniform(0.0, 0.05, (nb, b, b)))
        base = rng.standard_normal((nb, b, d))
    elif kind == "int":
        mask = np.tril(rng.random((nb, b, b)) < 0.05, -1)
        base = rng.integers(0, 3, (nb, b, d))
    elif kind == "sparse":
        mask = np.tril(rng.random((nb, b, b)) < 0.002, -1)
        base = rng.integers(0, 2, (nb, b, d))
    elif kind == "nan":
        # NaN on the diagonal and above: none of it may reach the output
        mask = np.where(np.tri(b, b, -1, dtype=bool),
                        rng.random((nb, b, b)) < 0.5, np.nan)
        base = rng.integers(0, 2, (nb, b, d))
    else:  # random 0/1
        mask = np.tril(rng.random((nb, b, b)) < 0.5, -1)
        base = rng.integers(0, 2, (nb, b, d))
    return (torch.as_tensor(base, dtype=dtype, device=dev),
            torch.as_tensor(mask, dtype=dtype, device=dev))


def phase_kernels(torch, np) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.hamlet_dense import (dense_propagate_cuda,
                                                  dense_propagate_work)
    from repro_torch.kernels.hamlet_propagate import (
        masked_prefix_propagate_cuda, masked_propagate_work)
    from repro_torch.kernels.timing import bound, device_ms

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    f64, f32, i32 = torch.float64, torch.float32, torch.int32
    entries = {}

    # masked prefix propagation: (name, shape, dtype, mask kind, tolerance)
    checks = []
    cases = [("random 0/1 mask", (78, 313, 2), f64, "random", 1e-12),
             ("all-ones mask (saturates)", (1, 1100, 2), f64, "ones", 1e-12),
             ("random mask, f32", (78, 313, 2), f32, "f32", 1e-5),
             ("random 0/1 mask, int32 (exact)", (78, 313, 2), i32, "int", 0.0),
             ("solved rows in global memory", (1, 6144, 2), f64, "sparse",
              1e-12),
             ("NaN on and above the diagonal", (78, 313, 2), f64, "nan",
              1e-12),
             ("more blocks than SMs", (200, 65, 2), f64, "random", 1e-12),
             ("int32, 4-column chunk (exact)", (16, 65, 3), i32, "int", 0.0)]
    # column chunking (d 1, 3, 5) and the tile and lookahead edges of b
    cases += [(f"random 0/1 mask, d={d}", (78, 313, d), f64, "random", 1e-12)
              for d in (1, 3, 5)]
    cases += [(f"random 0/1 mask, b={b}", (8, b, 2), f64, "random", 1e-12)
              for b in (1, 31, 32, 33, 64, 65)]
    main = None
    for name, (nb, b, d), dtype, kind, tol in cases:
        base, mask = _masked_case(torch, np, rng, dev, nb, b, d, dtype, kind)
        got = masked_prefix_propagate_cuda(base, mask)
        torch.cuda.synchronize()
        want = ref.torch_prefix_propagate_batched(base, mask)
        c = compare(np, got, want)
        ok = c["nonfinite_equal"] and (c["bitwise_equal"] if tol == 0.0
                                       else c["max_rel_err"] <= tol)
        c.update(case=name, shape=[nb, b, d], dtype=str(dtype)[6:], tol=tol,
                 ms=device_ms(lambda: masked_prefix_propagate_cuda(
                     base, mask)))
        checks.append(c)
        log(f"[kernels] hamlet_propagate {name} {(nb, b, d)}: {c}")
        if not ok:
            fail(f"hamlet_propagate disagrees with its plain version: {name}")
        if main is None:
            main = (base, mask, c)
    base, mask, c = main
    nb, b, d = base.shape
    plain_ms = wall_ms(torch, lambda: ref.torch_prefix_propagate_batched(
        base, mask))
    neg = -mask
    lib_ms = device_ms(lambda: torch.linalg.solve_triangular(
        neg, base, upper=False, unitriangular=True))
    bms, by = bound(*masked_propagate_work(nb, b, d), "float64")
    entries["hamlet_propagate"] = {
        "name": "hamlet_propagate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hamlet_propagate.cu",
        "replaces": "src/repro/kernels/hamlet_propagate.py:69",
        "shape": [nb, b, d], "dtype": "float64",
        "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
        "library_call": "torch.linalg.solve_triangular(-mask, base, "
                        "unitriangular=True)",
        "checks": checks}

    # dense burst propagation: (name, shape, dtype, input kind, tolerance;
    # 0.0 means bitwise)
    checks = []
    cases = [("f64", (485, 512, 2), f64, "real", 1e-12),
             ("f32 (saturates)", (485, 512, 2), f32, "f32", 1e-5),
             ("f64 integer-valued (exact)", (485, 512, 2), f64, "int", 0.0),
             ("+inf entries", (16, 512, 3), f64, "inf", 1e-12),
             ("one batch element", (1, 512, 2), f64, "real", 1e-12),
             ("f32, 3-column chunk", (8, 33, 3), f32, "f32", 1e-5)]
    # the lanes' 16-row runs (b around 16 and 32) and the 512 cap, exact
    cases += [(f"integer-valued, b={b}", (8, b, 2), f64, "int", 0.0)
              for b in (1, 2, 15, 16, 17, 31, 32, 33, 511, 512)]
    # column chunking (d 1, 3, 5) with more batch elements than SMs
    cases += [(f"f64, d={d}", (200, 512, d), f64, "real", 1e-12)
              for d in (1, 3, 5)]
    cases += [(f"integer-valued, d={d}", (200, 100, d), f64, "int", 0.0)
              for d in (1, 3, 5)]
    main = None
    for name, (nb, b, d), dtype, kind, tol in cases:
        base = torch.as_tensor(_dense_base(np, rng, nb, b, d, kind),
                               dtype=dtype, device=dev)
        got = dense_propagate_cuda(base)
        torch.cuda.synchronize()
        want = ref.prefix_propagate_dense_torch_batched(base)
        c = compare(np, got, want)
        ok = c["nonfinite_equal"] and (c["bitwise_equal"] if tol == 0.0
                                       else c["max_rel_err"] <= tol)
        c.update(case=name, shape=[nb, b, d], dtype=str(dtype)[6:], tol=tol,
                 ms=device_ms(lambda: dense_propagate_cuda(base)))
        checks.append(c)
        log(f"[kernels] hamlet_dense {name} {(nb, b, d)}: {c}")
        if not ok:
            fail(f"hamlet_dense disagrees with its plain version: {name}")
        if kind == "inf" and not c["nonfinite"]:
            fail("hamlet_dense +inf check: no non-finite value compared")
        if main is None:
            main = (base, c)
    try:
        dense_propagate_cuda(torch.zeros(1, 513, 2, dtype=f64, device=dev))
    except ValueError as e:
        log(f"[kernels] hamlet_dense b=513 refused: {e}")
    else:
        fail("hamlet_dense took b = 513, past the 512 cap")
    # padding invariance: a burst alone and zero-padded after its rows, as
    # the executor pads buckets to next_pow2(b), gives bitwise the same rows
    burst = rng.random((4, 100, 2)) * 3.0
    alone = dense_propagate_cuda(torch.as_tensor(burst, device=dev))
    for bp in (128, 256):
        padded = np.zeros((4, bp, 2))
        padded[:, :100] = burst
        got = dense_propagate_cuda(torch.as_tensor(padded, device=dev))
        if not torch.equal(got[:, :100], alone):
            fail(f"hamlet_dense: rows 0..99 differ when padded to {bp} rows")
    c = compare(np, alone, ref.prefix_propagate_dense_torch_batched(
        torch.as_tensor(burst, device=dev)))
    if c["max_rel_err"] > 1e-12:
        fail(f"hamlet_dense: the b = 100 burst disagrees: {c}")
    log("[kernels] hamlet_dense padding invariance: b=100 alone, padded to "
        "128 and to 256 rows: rows 0..99 bitwise equal")
    checks.append(dict(c, case="padding invariance (b=100 | 128 | 256)",
                       shape=[4, 100, 2], dtype="float64", tol=1e-12,
                       padded_rows_bitwise=True))

    base, c = main
    nb, b, d = base.shape
    plain_ms = wall_ms(torch, lambda: ref.prefix_propagate_dense_torch_batched(
        base))
    # one library call for the same function, the way the TPU kernel
    # computes it: the closed-form matrix W = (I - L)^{-1} (1 on the
    # diagonal, 2^{i-j-1} below it, exact host powers of two) times base;
    # and the more general unit-lower solve on the all-ones mask (timed
    # here only; the port calls neither)
    i = np.arange(b)
    w = torch.as_tensor(np.where(i[:, None] > i[None, :],
                                 2.0 ** (i[:, None] - i[None, :] - 1.0),
                                 (i[:, None] == i[None, :]).astype(float)),
                        dtype=f64, device=dev)
    lc = compare(np, torch.matmul(w, base),
                 ref.prefix_propagate_dense_torch_batched(base))
    log(f"[kernels] torch.matmul(W, base) against the plain version: {lc}")
    if not lc["nonfinite_equal"] or lc["max_rel_err"] > 1e-12:
        fail("torch.matmul(W, base) disagrees with the plain version")
    lib_ms = device_ms(lambda: torch.matmul(w, base))
    neg = torch.tril(torch.ones(b, b, dtype=f64, device=dev), -1).neg()
    neg = neg.expand(nb, b, b).contiguous()
    solve_ms = device_ms(lambda: torch.linalg.solve_triangular(
        neg, base, upper=False, unitriangular=True))
    del neg, w
    bms, by = bound(*dense_propagate_work(nb, b, d), "float64")
    entries["hamlet_dense"] = {
        "name": "hamlet_dense", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/hamlet_dense.cu",
        "replaces": "src/repro/kernels/hamlet_dense.py:54",
        "shape": [nb, b, d], "dtype": "float64",
        "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
        "library_call": "torch.matmul(W, base), W = (I - L)^{-1}",
        "solve_triangular_ms": solve_ms,
        "checks": checks}
    return entries


def _dense_base(np, rng, nb, b, d, kind):
    """Inputs of the dense checks: non-integer values in [0, 3) ("real"),
    f32-scale values that saturate f32 within 512 rows ("f32"), integers
    0..2 in the last 48 rows and zero before, so that the counts stay below
    2^53 while the last lanes' carries still go through the scan ("int"),
    or "real" with about one entry in 500 set to +inf ("inf")."""
    if kind == "f32":
        return rng.random((nb, b, d)) * 1e-4
    if kind == "int":
        x = rng.integers(0, 3, (nb, b, d)).astype(np.float64)
        x[:, :max(0, b - 48)] = 0.0
        return x
    x = rng.random((nb, b, d)) * 3.0
    if kind == "inf":
        x[rng.random((nb, b, d)) < 0.002] = np.inf
    return x


def main_config(events_per_minute: int = 20000):
    """``overload_64plus_pred_full``: the full-size overload_64plus stream
    of benchmarks/bench_e2e.py (20,000 ev/min for 6 min, ramp to 1.5x, one
    4x flash crowd) under paper workload 1 with Kleene predicates on every
    third query, DynamicPolicy, K = 16.  ``events_per_minute`` cuts the
    rate and nothing else (see ``FINITE_CUT``)."""
    from repro_torch.core.optimizer import DynamicPolicy
    from repro_torch.core.pattern import EventType, Kleene, Seq
    from repro_torch.core.query import Pred, Query, Workload, count_star
    from repro_torch.streams.generator import (RIDESHARING_SCHEMA,
                                               OverloadStreamConfig,
                                               overload_stream)

    travel = EventType("Travel")
    heads = ("Request", "Pickup", "Dropoff")
    qs = []
    for i in range(8):
        preds = ({"Travel": [Pred("speed", "<", 4.0 + i % 5)]}
                 if i % 3 == 2 else None)
        qs.append(Query(f"q{i}", Seq(EventType(heads[i % 3]), Kleene(travel)),
                        aggs=(count_star(),), preds=preds, within=60,
                        slide=15))
    wl = Workload(RIDESHARING_SCHEMA, qs)
    stream = overload_stream(OverloadStreamConfig(
        schema=RIDESHARING_SCHEMA, base_events_per_minute=events_per_minute,
        minutes=6, ramp_to=1.5, flash_crowds=((180, 10, 4.0),), n_groups=1,
        burstiness=0.9, type_weights=(1, 1, 6, 1, 1, 1), seed=7))
    return wl, stream, DynamicPolicy


def hold(np, got: dict, want: dict, rtol_of, what: str) -> tuple[int, int]:
    """Hold window results against the oracle's: equal keys, equal
    non-finite pattern, finite values within ``rtol_of(agg)``.  Returns the
    number of bitwise-equal windows and the number of finite values held."""
    from repro_torch.core.engine import vals_equal

    if got.keys() != want.keys():
        fail(f"{what}: window keys differ ({len(got)} vs {len(want)})")
    for k, w in want.items():
        g = got[k]
        if g.keys() != w.keys():
            fail(f"{what}: aggregates differ at {k}")
        for a, wv in w.items():
            gv = g[a]
            if (math.isnan(gv), math.isinf(gv) and gv > 0,
                    math.isinf(gv) and gv < 0) != (
                    math.isnan(wv), math.isinf(wv) and wv > 0,
                    math.isinf(wv) and wv < 0):
                fail(f"{what}: non-finite pattern differs at {k} {a}: "
                     f"{gv} vs {wv}")
            if math.isfinite(wv) and abs(gv - wv) > rtol_of(a) * abs(wv):
                fail(f"{what}: {k} {a} = {gv}, oracle {wv}")
    finite = sum(math.isfinite(v) for r in want.values() for v in r.values())
    return sum(vals_equal(got[k], want[k]) for k in want), finite


def _run(torch, HamletRuntime, wl, stream, policy, backend):
    rt = HamletRuntime(wl, policy=policy(), backend=backend, micro_batch=16,
                       plan_cache=True, fold_exec=True)
    t0 = time.perf_counter()
    res = rt.run(stream)
    if backend != "np":
        torch.cuda.synchronize()
    return res, rt, time.perf_counter() - t0


def phase_main(torch, np) -> dict:
    from repro_torch.core.engine import HamletRuntime
    from repro_torch.kernels.hamlet_dense import dense_propagate_cuda
    from repro_torch.kernels.hamlet_propagate import \
        masked_prefix_propagate_cuda

    wl, stream, policy = main_config()
    log(f"[main] {MAIN_CONFIG}: {len(stream)} events, {len(wl.queries)} "
        f"queries, K=16")
    for fn in (masked_prefix_propagate_cuda, dense_propagate_cuda):
        fn.launches = 0
        fn.shapes.clear()
    got, rt, wall = _run(torch, HamletRuntime, wl, stream, policy, "cuda")
    launches = {"hamlet_propagate": masked_prefix_propagate_cuda.launches,
                "hamlet_dense": dense_propagate_cuda.launches}
    shapes = {"hamlet_propagate": masked_prefix_propagate_cuda.shapes.copy(),
              "hamlet_dense": dense_propagate_cuda.shapes.copy()}
    s = rt.stats
    split = {k: round(v, 4) for k, v in s.phase_split().items()}
    log(f"[main] cuda: wall {wall:.3f} s, {len(stream) / wall:.0f} events/s, "
        f"windows {len(got)}, panes {s.panes}, phase seconds plan "
        f"{s.plan_s:.3f} execute {s.execute_s:.3f} finalize "
        f"{s.finalize_s:.3f} fold {s.fold_s:.3f} (split {split}), "
        f"executor launches {rt.executor.launches}, fold launches "
        f"{rt.fold_exec.launches}, kernel launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"main path never launched {name}")
    want, rt_np, wall_np = _run(torch, HamletRuntime, wl, stream, policy, "np")
    log(f"[main] np oracle: wall {wall_np:.3f} s, "
        f"{len(stream) / wall_np:.0f} events/s")
    if not want:
        fail("main path emitted no windows")
    same, finite = hold(np, got, want, lambda a: RTOL_MAIN, "main path")
    nonfinite = sum(len(r) for r in want.values()) - finite
    log(f"[main] held against np: {len(want)} windows, {same} bitwise equal, "
        f"{finite} finite values within rtol {RTOL_MAIN}, {nonfinite} "
        f"non-finite (saturated) values with the same pattern")

    # the same configuration at FINITE_CUT ev/min: finite windows through
    # both kernels
    wl_c, stream_c, _ = main_config(FINITE_CUT)
    masked_prefix_propagate_cuda.launches = 0
    dense_propagate_cuda.launches = 0
    got_c, _, wall_c = _run(torch, HamletRuntime, wl_c, stream_c, policy,
                            "cuda")
    cut_launches = {"hamlet_propagate": masked_prefix_propagate_cuda.launches,
                    "hamlet_dense": dense_propagate_cuda.launches}
    want_c, _, _ = _run(torch, HamletRuntime, wl_c, stream_c, policy, "np")
    same_c, finite_c = hold(np, got_c, want_c, lambda a: RTOL_MAIN,
                            "finite cut")
    log(f"[main] finite cut ({FINITE_CUT} ev/min, {len(stream_c)} events): "
        f"wall {wall_c:.3f} s, kernel launches {cut_launches}; held against "
        f"np: {len(want_c)} windows, {same_c} bitwise equal, {finite_c} "
        f"finite values within rtol {RTOL_MAIN}")
    if finite_c == 0:
        fail("finite cut: no finite value was compared")
    for name, n in cut_launches.items():
        if n <= 0:
            fail(f"finite cut never launched {name}")

    # the same run under the profiler: device busy share and kernel times
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall_p = _run(torch, HamletRuntime, wl, stream, policy, "cuda")
    # device-side activities only (kernels, copies); a CPU op such as
    # aten::copy_ reports its copy's time again as its own device time
    dev_us = 0.0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = ev.self_device_time_total
        if t > 0:
            dev_us += t
            rows.append((t, ev.key, ev.count))
    rows.sort(reverse=True)
    log(f"[main] profiled run: wall {wall_p:.3f} s, device time "
        f"{dev_us / 1e6:.4f} s, busy share {dev_us / 1e6 / wall_p:.4f}")
    for t, key, n in rows[:8]:
        log(f"[main]   {t / 1e3:10.3f} ms  x{n:<6d} {key[:90]}")
    return {"launches": launches, "wall_s": wall, "events": len(stream),
            "windows": len(want), "bitwise": same,
            "shapes": {name: shape_report(
                torch, np, name, counts,
                sum(t for t, key, _ in rows if PROFILER_KEYS[name] in key)
                / 1e3) for name, counts in shapes.items()}}


# the kernels' function names, as the profiler's keys hold them
PROFILER_KEYS = {"hamlet_propagate": "masked_propagate_kernel",
                 "hamlet_dense": "dense_propagate_kernel"}


def shape_report(torch, np, name: str, shapes, prof_ms: float) -> dict:
    """A kernel's main-path launches by ``(nb, b, d, dtype)``: the most
    frequent shapes, the bound summed over every launch against the
    profiler's total device time for the kernel, and every distinct shape
    timed again alone on random 0/1 inputs (10 calls behind a short spin),
    so that the shapes that cost the most (count x device ms) are known."""
    from repro_torch.kernels.hamlet_dense import (dense_propagate_cuda,
                                                  dense_propagate_work)
    from repro_torch.kernels.hamlet_propagate import (
        masked_prefix_propagate_cuda, masked_propagate_work)
    from repro_torch.kernels.timing import bound, device_ms

    fn, work = {"hamlet_propagate": (masked_prefix_propagate_cuda,
                                     masked_propagate_work),
                "hamlet_dense": (dense_propagate_cuda,
                                 dense_propagate_work)}[name]
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(1)
    n = sum(shapes.values())
    log(f"[main] {name} shapes: {n} launches, {len(shapes)} distinct "
        f"(nb, b, d, dtype); most frequent:")
    for shape, k in shapes.most_common(10):
        log(f"[main]   x{k} {shape}")
    rows = []
    for (nb, b, d, dt), k in shapes.items():
        dtype = getattr(torch, dt)
        bms, _ = bound(*work(nb, b, d, dtype.itemsize), dt)
        args = [torch.as_tensor(rng.integers(0, 2, (nb, b, d)), dtype=dtype,
                                device=dev)]
        if fn is masked_prefix_propagate_cuda:
            args.append(torch.as_tensor(
                np.tril(rng.random((nb, b, b)) < 0.5, -1), dtype=dtype,
                device=dev))
        ms = device_ms(lambda: fn(*args), launches=10, reps=3, warmup=1,
                       spin=5_000_000)
        rows.append((k * ms, k, (nb, b, d, dt), ms, bms))
    rows.sort(reverse=True)
    bound_sum = sum(k * bms for _, k, _, _, bms in rows)
    replay = sum(r[0] for r in rows)
    log(f"[main] {name} over the main path: profiler {prof_ms:.6f} ms "
        f"device time, {replay:.6f} ms replayed shape by shape, summed bound "
        f"{bound_sum:.6f} ms ({bound_sum / prof_ms if prof_ms else 0:.4f} "
        f"of the profiler's)")
    log(f"[main] {name} costliest shapes (count x device ms):")
    for tot, k, shape, ms, bms in rows[:20]:
        log(f"[main]   {tot:.6f} ms = x{k} {shape} at {ms:.6f} ms "
            f"(bound {bms:.7f})")
    return {"launches": n, "distinct": len(shapes), "profiler_ms": prof_ms,
            "replayed_ms": replay, "bound_ms": bound_sum,
            "costliest": [[list(s), k, ms, bms]
                          for _, k, s, ms, bms in rows[:20]]}


def phase_cli(torch, np) -> None:
    from repro_torch.launch import hamlet_service

    runs = {}
    for backend in ("cuda", "np"):
        args = hamlet_service.parse_args(["--backend", backend])
        res, rt, batch, dt = hamlet_service.run_default(args)
        runs[backend] = res
        log(f"[cli] {backend}: {len(batch)} events, {len(res)} windows, "
            f"wall {dt:.3f} s, device {rt.device}")
    same, finite = hold(np, runs["cuda"], runs["np"],
                        lambda a: 0.0 if a.startswith("COUNT") else RTOL_SUM,
                        "cli")
    log(f"[cli] held against np: COUNT exact, SUM/AVG rtol {RTOL_SUM}; "
        f"{finite} finite values; {same} of {len(runs['np'])} windows "
        f"bitwise equal (vals_equal)")


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    # the plain versions' float32 matmuls run in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()

    card = phase_env(torch)
    phase_build()
    kernels = phase_kernels(torch, np)
    main_res = phase_main(torch, np)
    phase_cli(torch, np)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro."))
                    or m == "repro")
    if leaked:
        fail(f"imported the JAX package or jax: {leaked[:5]}")
    for name, e in kernels.items():
        e["launches"] = main_res["launches"][name]
        e["main_path"] = main_res["shapes"][name]
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(kernels.values()),
                      "card": card, "config": MAIN_CONFIG}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
