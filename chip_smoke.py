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
              micro_batch=16, fold_exec=True).run(...)``, on
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
              held against ``backend="np"``;
6. baselines — the paper's Fig. 9 comparison (``repro_torch.launch.fig9``):
              at 1,000 ev/min (every window finite) GRETA on the masked
              kernel held against GRETA on numpy and against HAMLET, SHARON
              (host) against GRETA, MCEP and brute force at 30 and 60
              ev/min against GRETA, and a MIN/MAX variant under HAMLET on
              cuda against np at K 1 and 16; at 20,000 ev/min (the paper's
              scale, 40,000 events) HAMLET and GRETA timed, GRETA's wall
              split into host adjacency, mask copy, kernel and fetch, GRETA
              held against HAMLET (same keys, same non-finite values), the
              kernel's count vectors on three windows held against the
              plain versions on the card, and the kernel alone at GRETA's
              smallest and largest shape with its bound and
              ``solve_triangular``; between them, at 8,000 ev/min for one
              minute, GRETA and the MIN/MAX variant on cuda held to the
              row loop wherever the numpy doubling overflows while the row
              loop stays finite (``ref.exact_oracle``);
7. obs      — the finite cut of the main configuration with
              ``Observability()`` attached, bitwise equal to the run without
              it, phase spans against the ``RunStats`` timers and the audit
              summary; then the CLI's ``--trace`` on the card into
              ``build/chip_smoke_trace.jsonl``;
8. stream   — the streaming layers on the card: ``HamletService`` fed the
              main configuration in one-minute chunks (every window equal
              to the main phase's batch run; its 1,000 ev/min cut against
              the np service); ``OverloadRuntime`` on fig_overload's
              SLO-control stream with fixed shedding (shed sets, the error
              accountant and windows against np; K 1 and 4, pipelined)
              and with the live controller at 2x the calibrated capacity
              (per-pane p50/p99 ms against the SLO, shed fraction, recall,
              the device's busy share; shedding's end-to-end p99 must fall
              below the unshed run's); ``EventTimeRuntime`` on
              fig_disorder's ridesharing row, speculative and buffered,
              against the in-order cuda run and the in-order np run (the
              cuda run first held against np), with ``ops.fold_stacked``'s
              device time in the revision storms from the profiler, and the
              service's event-time mode on the same stream.

9. shards   — the sharded service (``repro_torch.shardsvc``) on the card:
              first the pane-batch sharding hook (the main configuration's
              finite cut with ``shard_slices=pane_bucket_shards(nb, 3)``
              bitwise equal to the cut without it, with more launches);
              then fig_shard_scale's configuration in its quick mode
              (``SHARDS_QUICK``; ``repro_torch.launch.fig_shard_scale``: one
              replica of 4 tenants a shard, 4 replicas pinned on 4 shards)
              held against the np 1-shard run (COUNT exact below 2^53,
              rtol 1e-12 above, bitwise windows printed): the cuda 1-shard
              run, then the 4-shard serial, thread and process drives,
              each with wall, events/s, router and per-shard busy time,
              per-shard p99 ``proc_ms`` and the host's CPU count; the
              thread drive's shard executor launches must add up to the
              kernels' counters, and each worker process must report
              launches and no module of jax or of the JAX package; one
              rebalance (serial); the predicate variant in process mode
              (the masked kernel in every worker process); a flash crowd
              on one shard (its isolation printed, not gated);
10. serve   — the serving tier (``repro_torch.serve``) on fig_shard_scale's
              one-replica stream: 32 trickle sessions with an inline pump
              against ``OverloadRuntime.run`` on the merged stream (itself
              held against np), events/s of both; the same sessions paced
              on threads with the background pump (per-session delivery
              latency p50/p99 from every delivery); the sharded adapter
              with 2 shards on the thread drive (each shard launching);
              and a ``ServingServer`` with 8 ``ServingClient``s over
              loopback, every END frame held against the in-process run,
              no thread and no fd left after ``stop()``;
11. lm      — the LM substrate (``repro_torch.{configs,models}``,
              ``serve.ServeEngine``, ``launch.serve``; plain torch ops, no
              TPU kernel): all ten architectures at ``reduce_for_smoke``
              size in f32 on the card against the CPU (forward logits,
              rtol 1e-4) and prefill + decode against forward on the card
              (2e-3), h2o-danube's smoke engine tokens equal to the CPU's;
              gemma2-2b at full width in bf16 through ``launch.serve``'s
              ``generate`` (batch 4, prompt 6,144, 32 tokens: parameters,
              weight bytes, peak memory, prefill ms, decode ms per step,
              tok/s, every logit finite) and four decode steps under the
              profiler; decode consistency at 6,144 tokens (ring slot
              2,048) in bf16 (0.12) and, with the weights cast, in f32
              (2e-3); ``ServeEngine`` with 8 heavy-tailed requests in two
              gangs; batched against sequential first-token logits in f32.
              Sets ``allow_bf16_reduced_precision_reduction = False``.
12. width   — the serving path of the eight architectures that fit one
              card (whisper-tiny, h2o-danube-1.8b, gemma3-4b, zamba2-7b,
              olmoe-1b-7b, rwkv6-7b, qwen2-vl-7b, starcoder2-15b, in that
              order) at their published configurations, bf16, seed 0,
              through ``launch.serve``'s ``generate``: batch 2, prompts of
              2,048 tokens, 16 tokens, after a warm-up (parameters, weight
              bytes, prefill ms, decode ms per step p50/min/max, tok/s,
              peak memory, every logit finite) and one decode step under
              the profiler; then at full width, float32, the depth cut to
              the fewest whole layer cycles with at least 4 layers and MoE
              dropless, every logit ``generate`` chose a token from against
              the teacher-forced forward over the prompt and the fed-back
              tokens (2e-3; zamba2-7b 1.2e-2, ``RTOL_WIDTH``), and that
              forward's first row alone against the batch's (printed);
              each model freed before the next;
              llama4-maverick left out (its weights outgrow the card);
13. train   — the LM substrate's training path (``models.lm``'s loss and
              train step, ``train/``, ``distributed/checkpoint.py``; plain
              torch ops and autograd, no TPU kernel): the ten smoke
              architectures in f32 on the card against the CPU (loss rel
              1e-5; gradients, and AdamW fed the CPU's gradients, within
              1e-4 of each leaf's max abs, zamba2's gradients 5e-4, as in
              tests/test_torch_train.py; a second step through
              ``train_step_fn``, its loss held); ``run_training`` at
              gemma2-2b's smoke size on the card, 12 steps, a crash at
              step 9 and a resume from step 8, bitwise equal to the
              uninterrupted run; gemma2-2b at full width in bf16 with f32
              AdamW moments, batch 2 x 5,120, one warm-up and five timed
              steps (step ms, tokens/s, peak memory, every loss, the
              global gradient norm, all finite; the bf16 and f32 FLOPs of
              a step at the data sheet's peaks as its bound).
14. train_width — the training path at the published widths: the memory
              plan of the nine architectures but gemma2-2b, on the meta
              device (parameters, one gradient a parameter, AdamW moments
              in f32 or bf16, and 14 GB of activations a 4,096-token row
              against 80 GB; a cut batch listed in ``reduced``;
              starcoder2-15b and llama4-maverick left out with their
              bytes); then whisper-tiny, h2o-danube-1.8b, gemma3-4b,
              zamba2-7b, olmoe-1b-7b, rwkv6-7b and qwen2-vl-7b in that
              order, each first in f32 at full width and the ``width``
              phase's cut depth, batch 1 x 256, one model on the CPU and
              its copy on the card (loss rel 1e-5, gradients 1e-4 of each
              leaf's max abs, zamba2-7b 1.2e-2; the card's gradients of the
              row twice against once printed), then at full width and
              depth in bf16 with the planned moments at 4,096 tokens a row
              (whisper's frames, qwen2-vl's patch embeddings and M-RoPE
              positions as the train_4k cell lays them out): a warm-up
              step under ``hlo_analysis.MatmulFlops``, whose
              matrix-product FLOPs by type at 989/67 TFLOP/s are the step's
              bound, two timed steps (step ms, tokens/s, states and peak
              memory, every loss, the global gradient norm, all finite),
              one step under the profiler (device ms, busy share, matrix
              products' share); each model freed before the next; then
              ``run_training``'s crash and resume bitwise at olmoe-1b-7b's
              and zamba2-7b's smoke sizes.
15. dist    — the distributed substrate (``repro_torch.distributed``:
              compression, pipeline, mesh rules, checkpoint resharding;
              torch ops and ``torch.distributed``): four gloo ranks spawned
              on a ``file://`` store, all on cuda:0 (NCCL refuses two ranks
              on one device), each CUDA collective staged through the host
              by ``distributed.comm`` and timed: ``compressed_psum_tree``
              on gemma2-2b smoke gradients bitwise against the compressed
              step's sync of the stacked ranks in one process;
              ``pipelined_apply`` against ``sequential_apply`` at L 8, B
              64, D 2,304, 4 micro-batches, f32 (1e-5); the parameter
              rules through ``distribute_tensor`` on a (2, 2) data x model
              mesh (local shapes, ``full_tensor`` equal); an elastic
              restore from a 1-D mesh of 4 onto the (2, 2) mesh, bitwise;
              ``shard_pane_bucket`` of a main-path masked bucket, each
              rank's rows through the masked kernel bitwise equal to those
              rows of one launch (these are the kernel's ``dist``
              launches).  Then gemma2-2b at full width, bf16, f32 AdamW
              moments, batch 2 x 5,120 over two pods with
              ``dp_compressed_step_fn``: step 1 in its three parts, timed,
              its sync of ``embed``, ``layers.0.attn.wq`` and
              ``layers.0.ln1`` (scale, int8 payload, int32 sum, synced
              gradients, new errors) bitwise against the same sync on the
              CPU, its parameters within 5e-3 of ``train_step_fn``'s from
              the same start; three timed steps (step ms p50, tokens/s,
              peak memory, losses and error norms, all finite).
16. lower   — the lowering proofs (``repro_torch.launch.dryrun``,
              ``launch.hlo_analysis``; traces of ``meta`` tensors on
              placeholder worlds, run in this process, no GPU needed): the
              HAMLET pane step on the (16, 16) and (2, 16, 16) meshes,
              gemma2-2b's prefill_32k and train_4k on the (16, 16) mesh,
              and there one cheap cell of each architecture whose trace
              runs an einsum or the MoE dispatch per shard (olmoe-1b-7b's
              prefill_32k and decode_32k, llama4-maverick's decode_32k,
              whisper-tiny's train_4k, zamba2-7b's and rwkv6-7b's
              decode_32k), each record printed and ``ok``; the proof's FLOPs of
              gemma2-2b's train step at batch 2 x 5,120 on a 1-rank world
              equal to ``FlopCounterMode`` over one real step on the card
              and within 1% of ``train_flops``; the pane step's body at
              its full shape on the card (G 4,096 bursts of 256 rows, f32,
              seeded counts, masks of density 0.5), its device ms, its
              masked part against the masked kernel and its dense part
              against the dense kernel (finite entries within 1e-4, each
              kernel's non-finite pattern equal to its np oracle's, the
              twins' counted: these are the kernels' ``lower``
              launches).

Each path's kernel launches are counted from zero just before it runs; a
path that should launch a kernel and did not fails the run.

The last three lines of standard output are the kernels' JSON record, the
card's ``name, power.limit`` as nvidia-smi prints them, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
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


def hold(np, got: dict, want: dict, rtol_of, what: str,
         exact_counts: bool = False) -> tuple[int, int]:
    """Hold window results against the oracle's: equal keys, equal
    non-finite pattern, finite values within ``rtol_of(agg)`` (and, with
    ``exact_counts``, COUNT values below 2^53 exactly equal).  Returns the
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
            if (exact_counts and a.startswith("COUNT") and abs(wv) < 2 ** 53
                    and gv != wv):
                fail(f"{what}: {k} {a} = {gv}, oracle {wv} (exact below "
                     "2^53)")
    finite = sum(math.isfinite(v) for r in want.values() for v in r.values())
    return sum(vals_equal(got[k], want[k]) for k in want), finite


def _run(torch, HamletRuntime, wl, stream, policy, backend):
    rt = HamletRuntime(wl, policy=policy(), backend=backend, micro_batch=16,
                       fold_exec=True)
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
            "windows": len(want), "bitwise": same, "results": got,
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


# --------------------------------------------------------------------------
# the paper's baselines (fig9's workload) and the observability layer
# --------------------------------------------------------------------------

# fig9's workload (benchmarks/fig9_vs_sota.py, copied into repro_torch
# .launch.fig9) at three rates: 1,000 ev/min for 2 min (2,000 events, 236-267
# events a GRETA window, every window finite), 20,000 ev/min (40,000 events,
# ~4,900-5,100 a window: the top of the paper's 10K-20K range), and the toy
# rates MCEP's and brute force's trend enumeration can finish: fig9's 30
# ev/min, whose windows hold no trend, and 60 ev/min, the least rate whose
# windows do
FIG9_FINITE = 1000
FIG9_PAPER = 20000
FIG9_TOY = (30, 60)
# fig9 at 8,000 ev/min for one minute: the counts of some windows are
# finite but past the numpy doubling's range (see phase_large_finite)
FIG9_LARGE = 8000
# the MIN/MAX variant's extra aggregates, by query index (minmax_variant)
MINMAX_AGGS = (0, 1)
DEVICE = "cuda:0"


def _reset(*fns) -> None:
    for fn in fns:
        fn.launches = 0
        fn.shapes.clear()


def _kind(v: float) -> str:
    if math.isnan(v):
        return "nan"
    if math.isinf(v):
        return "+inf" if v > 0 else "-inf"
    return "finite"


def hold_saturated(got: dict, want: dict, what: str, row_loop=None):
    """Hold saturated window results: equal keys, the same values
    non-finite, finite values within ``RTOL_MAIN``.  NaN against +inf is
    not a failure here (the algorithms saturate differently); the counts
    of each pairing of kinds are returned, ``(got, want) -> n``.  With
    ``row_loop`` (the row loop's values under the same keys) each value is
    held against ``exact_oracle(want, row_loop)``; the values held to the
    row loop are counted under ``("finite", "row loop")``."""
    from collections import Counter

    from repro_torch.kernels.ref import exact_oracle

    if got.keys() != want.keys():
        fail(f"{what}: window keys differ ({len(got)} vs {len(want)})")
    kinds = Counter()
    for k, w in want.items():
        if got[k].keys() != w.keys():
            fail(f"{what}: aggregates differ at {k}")
        for a, wv in w.items():
            gv = got[k][a]
            src = "doubling"
            if row_loop is not None:
                wv, src = exact_oracle(wv, row_loop[k][a])
            kinds[(_kind(gv), "row loop" if src == "row loop"
                   else _kind(wv))] += 1
            if math.isfinite(gv) != math.isfinite(wv):
                fail(f"{what}: {k} {a} = {gv}, against {wv} ({src})")
            if math.isfinite(wv) and abs(gv - wv) > RTOL_MAIN * abs(wv):
                fail(f"{what}: {k} {a} = {gv}, against {wv} ({src})")
    return dict(kinds)


def minmax_variant(wl):
    """fig9's workload with ``MIN(Travel.speed)`` added to q0 and
    ``MAX(Travel.duration)`` to q1."""
    import dataclasses

    from repro_torch.core.query import Workload, agg_max, agg_min

    extra = dict(zip(MINMAX_AGGS, (agg_min("Travel", "speed"),
                                   agg_max("Travel", "duration"))))
    qs = [dataclasses.replace(q, aggs=q.aggs + (extra[i],)) if i in extra
          else q for i, q in enumerate(wl.queries)]
    return Workload(wl.schema, qs)


def _timed(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_baselines(torch, np) -> dict:
    """fig9's comparison on the card: GRETA on the masked kernel held
    against its numpy oracle and against HAMLET, SHARON/MCEP/brute against
    GRETA, MIN/MAX under HAMLET on cuda against np; then the paper-scale
    rate, timed and split, with the kernel's count vectors held against
    the plain versions on three windows and its time at GRETA's largest
    shape."""
    from repro_torch.core.baselines.brute import brute_run
    from repro_torch.core.baselines.greta import (GretaTimers, greta_run,
                                                  window_adjacency)
    from repro_torch.core.baselines.mcep import mcep_run
    from repro_torch.core.baselines.sharon import sharon_run
    from repro_torch.core.engine import (ComponentContext, HamletRuntime,
                                         vals_equal)
    from repro_torch.core.events import pane_size_for
    from repro_torch.core.optimizer import DynamicPolicy
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hamlet_dense import dense_propagate_cuda
    from repro_torch.kernels.hamlet_propagate import (
        masked_prefix_propagate_cuda, masked_propagate_work)
    from repro_torch.kernels.timing import bound, device_ms
    from repro_torch.launch.fig9 import fig9_case

    masked, dense = masked_prefix_propagate_cuda, dense_propagate_cuda
    dev = torch.device(DEVICE)
    rtol = lambda a: RTOL_MAIN
    out = {"launches": {}}

    def hamlet(wl, stream, t_end, backend, K=1):
        rt = HamletRuntime(wl, policy=DynamicPolicy(), backend=backend,
                           micro_batch=K)
        if backend == "np":
            t0 = time.perf_counter()
            return rt.run(stream, t_end), time.perf_counter() - t0
        return _timed(torch, lambda: rt.run(stream, t_end))

    # 1. the finite cut
    wl, stream, t_end = fig9_case(FIG9_FINITE)
    _reset(masked, dense)
    got, wall_g = _timed(torch, lambda: greta_run(wl, stream, t_end,
                                                  backend="cuda"))
    n_launch = masked.launches
    out["launches"]["greta_finite"] = n_launch
    log(f"[baselines] fig9 at {FIG9_FINITE} ev/min: {len(stream)} events, "
        f"GRETA cuda wall {wall_g:.3f} s, {len(got)} windows, masked "
        f"kernel launches {n_launch} at (1, n, 1) f64, n "
        f"{min(s[1] for s in masked.shapes)}.."
        f"{max(s[1] for s in masked.shapes)}; dense {dense.launches}")
    if n_launch == 0:
        fail("GRETA never launched the masked kernel")
    if dense.launches:
        fail("GRETA launched the dense kernel")
    want = greta_run(wl, stream, t_end, backend="np")
    same, finite = hold(np, got, want, rtol, "GRETA cuda vs np",
                        exact_counts=True)
    log(f"[baselines] GRETA cuda held against GRETA np: {same} of "
        f"{len(want)} windows bitwise, {finite} finite values (COUNT exact "
        f"below 2^53, rtol {RTOL_MAIN} above)")
    ham, wall_h = hamlet(wl, stream, t_end, "cuda")
    same, finite = hold(np, got, ham, rtol, "GRETA cuda vs HAMLET cuda",
                        exact_counts=True)
    log(f"[baselines] GRETA cuda held against HAMLET cuda (wall "
        f"{wall_h:.3f} s): {same} of {len(ham)} windows bitwise, {finite} "
        f"finite values")
    if finite == 0:
        fail("finite cut: no finite GRETA value was compared")
    shar, wall_s = _timed(torch, lambda: sharon_run(wl, stream, t_end))
    same, _ = hold(np, shar, got, rtol, "SHARON vs GRETA", exact_counts=True)
    log(f"[baselines] SHARON (host) held against GRETA cuda: wall "
        f"{wall_s:.3f} s, {same} of {len(got)} windows bitwise")
    for rate in FIG9_TOY:
        wl_t, st_t, te_t = fig9_case(rate)
        g = greta_run(wl_t, st_t, te_t, backend="cuda")
        for name, fn in (("MCEP", mcep_run), ("brute", brute_run)):
            r, w = _timed(torch, lambda: fn(wl_t, st_t, te_t))
            same, _ = hold(np, r, g, lambda a: 0.0, f"{name} vs GRETA "
                           f"({rate} ev/min)", exact_counts=True)
            if same != len(g):
                fail(f"{name} vs GRETA at {rate} ev/min: {len(g) - same} "
                     "windows differ")
        log(f"[baselines] MCEP and brute at {rate} ev/min ({len(st_t)} "
            f"events): {len(g)} windows bitwise equal to GRETA cuda, "
            f"{sum(v['COUNT(*)'] for v in g.values()):.0f} trends in all")

    # MIN/MAX under HAMLET: cuda (counts from the masked kernel) against np
    wl_mm = minmax_variant(wl)
    for K in (1, 16):
        _reset(masked, dense)
        got_mm, wall_mm = hamlet(wl_mm, stream, t_end, "cuda", K)
        launches = {"hamlet_propagate": masked.launches,
                    "hamlet_dense": dense.launches}
        out["launches"][f"minmax_K{K}"] = launches
        if masked.launches == 0:
            fail(f"MIN/MAX run (K={K}) never launched the masked kernel")
        want_mm, _ = hamlet(wl_mm, stream, t_end, "np", K)
        same, finite = hold(np, got_mm, want_mm, rtol, f"MIN/MAX K={K}",
                            exact_counts=True)
        mm = 0
        for k, w in want_mm.items():
            if not all(math.isfinite(v) for a, v in w.items()
                       if a.startswith("COUNT")):
                continue
            for a, v in w.items():
                if a.startswith(("MIN", "MAX")):
                    if not vals_equal({a: got_mm[k][a]}, {a: v}):
                        fail(f"MIN/MAX K={K}: {k} {a} = {got_mm[k][a]}, "
                             f"np {v}")
                    mm += math.isfinite(v)
        if mm == 0:
            fail(f"MIN/MAX K={K}: no finite MIN/MAX value was compared")
        log(f"[baselines] MIN/MAX K={K}: wall {wall_mm:.3f} s, kernel "
            f"launches {launches}; held against np: {mm} finite MIN/MAX "
            f"values bitwise, {same} of {len(want_mm)} windows bitwise, "
            f"COUNT exact below 2^53 and rtol {RTOL_MAIN} above")

    # 1b. counts large but finite: fig9 at 8,000 ev/min for one minute
    out["large_finite"] = phase_large_finite(torch, np, hamlet)

    # 2. paper scale
    wl, stream, t_end = fig9_case(FIG9_PAPER)
    n_ev = len(stream)
    ham, wall_h = hamlet(wl, stream, t_end, "cuda")
    ham16, wall_h16 = hamlet(wl, stream, t_end, "cuda", 16)
    _reset(masked, dense)
    timers = GretaTimers()
    got, wall_g = _timed(torch, lambda: greta_run(
        wl, stream, t_end, backend="cuda", timers=timers))
    greta_shapes = masked.shapes.copy()
    out["launches"]["greta_paper"] = masked.launches
    if masked.launches == 0:
        fail("paper scale: GRETA never launched the masked kernel")
    split = timers.split()
    split["other_s"] = wall_g - sum(split.values())
    ns = sorted(s[1] for s in greta_shapes.elements())
    log(f"[baselines] fig9 at {FIG9_PAPER} ev/min: {n_ev} events; HAMLET "
        f"cuda K=1 wall {wall_h:.3f} s, {n_ev / wall_h:.1f} events/s (K=16 "
        f"{wall_h16:.3f} s, {n_ev / wall_h16:.1f} events/s); GRETA cuda wall "
        f"{wall_g:.3f} s, {n_ev / wall_g:.1f} events/s; HAMLET K=1 / GRETA "
        f"= {wall_g / wall_h:.2f}x")
    log(f"[baselines] GRETA split (s, synced at each boundary): "
        f"{ {k: round(v, 6) for k, v in split.items()} }; {timers.windows} "
        f"windows, {timers.propagations} propagations, masked launches "
        f"{masked.launches}, dense {dense.launches}; shapes (1, n, 1) f64, "
        f"n {ns[0]}..{ns[-1]}, {len(greta_shapes)} distinct: "
        f"{ {s[1]: k for s, k in sorted(greta_shapes.items())} } (n: count)")
    kinds = hold_saturated(got, ham, "GRETA vs HAMLET, paper scale")
    log(f"[baselines] GRETA cuda against HAMLET cuda: {len(ham)} windows, "
        f"same keys and non-finite values; kinds (GRETA, HAMLET) -> count: "
        f"{kinds}")
    kinds16 = hold_saturated(ham16, ham, "HAMLET K=16 vs K=1, paper scale")
    log(f"[baselines] HAMLET K=16 against K=1: kinds {kinds16}")

    # the kernel's count vectors on group 0, query 0 against the plain
    # versions on the card: the torch backend (doubling) and the row loop
    run_ids = ComponentContext(wl.schema, list(wl.atomic)).relevant_type_ids
    pane = pane_size_for(wl.windows)
    g0, q = stream.partition_by_group()[0], wl.atomic[0]
    windows = []
    for w0 in range(0, t_end - q.within + 1, q.slide):
        adj, start, _, _, _ = window_adjacency(
            wl.schema, q, g0.time_slice(w0, w0 + q.within), run_ids, pane=pane)
        mask = torch.as_tensor(adj, device=dev)
        base = torch.as_tensor(start[:, None], device=dev)
        kern = masked(base[None], mask[None])[0, :, 0].cpu().numpy()
        plain = ops.propagate(base, mask, backend="torch",
                              device=dev)[:, 0].cpu().numpy()
        row = ref.torch_prefix_propagate_batched(
            base[None], mask[None])[0, :, 0].cpu().numpy()
        held = {}
        for name, other in (("torch", plain), ("row loop", row)):
            bad = ~(np.isfinite(kern) & np.isfinite(other))
            first = int(np.argmax(bad)) if bad.any() else len(kern)
            err = (np.abs(kern[:first] - other[:first])
                   / np.maximum(1.0, np.abs(other[:first])))
            held[name] = {"first_nonfinite": first,
                          "max_rel_err": float(err.max()) if first else 0.0}
            if held[name]["max_rel_err"] > RTOL_MAIN:
                fail(f"group 0 q0 window {w0}: kernel and {name} differ "
                     f"before row {first} by {held[name]['max_rel_err']}")
        # the row loop is the kernel's plain version: the same rows saturate
        if not all(np.array_equal(f(kern), f(row))
                   for f in (np.isnan, np.isposinf, np.isneginf)):
            fail(f"group 0 q0 window {w0}: the kernel's non-finite rows "
                 "differ from the row loop's")
        nf = {name: {"nan": int(np.isnan(v).sum()),
                     "+inf": int(np.isposinf(v).sum())}
              for name, v in (("kernel", kern), ("torch", plain),
                              ("row loop", row))}
        windows.append({"w0": w0, "n": len(kern), "held": held,
                        "nonfinite": nf})
        log(f"[baselines] group 0 q0 window {w0}: n {len(kern)}; rows "
            f"before the first non-finite one held within {RTOL_MAIN}: "
            f"{held}; non-finite rows {nf}, the kernel's at the row loop's "
            f"positions")
        del mask, base

    # the kernel alone at GRETA's smallest and largest shape
    rng = np.random.default_rng(3)
    timing = {}
    for n in (ns[0], ns[-1]):
        base = torch.as_tensor(rng.integers(0, 2, (1, n, 1)),
                               dtype=torch.float64, device=dev)
        mask = torch.as_tensor(np.tril(rng.random((1, n, n)) < 0.5, -1),
                               dtype=torch.float64, device=dev)
        ms = device_ms(lambda: masked(base, mask), launches=10, reps=3,
                       warmup=1, spin=5_000_000)
        timing[n] = ms
    bms, by = bound(*masked_propagate_work(1, ns[-1], 1), "float64")
    neg = -mask
    lib_ms = device_ms(lambda: torch.linalg.solve_triangular(
        neg, base, upper=False, unitriangular=True), launches=10, reps=3,
        warmup=1, spin=5_000_000)
    plain_ms = wall_ms(torch, lambda: ref.torch_prefix_propagate_batched(
        base, mask), reps=3, warmup=1)
    del neg, mask, base
    lo, hi = len(ns) * timing[ns[0]], len(ns) * timing[ns[-1]]
    log(f"[baselines] masked kernel at (1, {ns[-1]}, 1) f64: "
        f"{timing[ns[-1]]:.6f} ms (at (1, {ns[0]}, 1): "
        f"{timing[ns[0]]:.6f}), bound {bms:.6f} ms "
        f"({by}), share {bms / timing[ns[-1]]:.4f}; solve_triangular "
        f"{lib_ms:.6f} ms; plain version (row loop) {plain_ms:.3f} ms; "
        f"GRETA's {len(ns)} launches {lo:.4f}-{hi:.4f} ms of kernel time")
    out.update({
        "finite_cut": {"events_per_minute": FIG9_FINITE},
        "paper": {"events_per_minute": FIG9_PAPER, "events": n_ev,
                  "hamlet_wall_s": wall_h, "hamlet_K16_wall_s": wall_h16,
                  "greta_wall_s": wall_g, "greta_split_s": split,
                  "greta_launches": len(ns), "n_min": ns[0], "n_max": ns[-1],
                  "kinds": {f"{a}|{b}": c for (a, b), c in kinds.items()},
                  "windows_g0_q0": windows},
        "greta_shape": {"shape": [1, ns[-1], 1], "dtype": "float64",
                        "ms": timing[ns[-1]], "ms_at_n_min": timing[ns[0]],
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": lib_ms, "plain_ms": plain_ms,
                        "kernel_total_ms": [lo, hi]}})
    return out


def phase_large_finite(torch, np, hamlet) -> dict:
    """fig9 at ``FIG9_LARGE`` ev/min for one minute (8,000 events, window 0
    of 4 groups x 5 queries, 1,971-2,034 events a GRETA window), where some
    counts are finite but past ~1e154: the numpy path's doubling overflows
    into NaN there while the row loop, the exact path, stays finite.  GRETA
    on the masked kernel is held against HAMLET on cuda (as at paper
    scale) and against the exact-path oracle (``ref.exact_oracle``: the
    numpy path, or the row loop where only the row loop is finite); the MIN/MAX
    variant on cuda at K 1 and 16 against the same rule, with MIN/MAX
    computed on the host from the doubling's and the row loop's counts.
    The doubling is run only where the row loop is finite (where the exact
    count overflows, every float path does)."""
    from repro_torch.core.baselines.greta import (_minmax_propagate,
                                                  greta_run,
                                                  window_adjacency)
    from repro_torch.core.engine import ComponentContext
    from repro_torch.core.events import pane_size_for
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.hamlet_dense import dense_propagate_cuda
    from repro_torch.kernels.hamlet_propagate import \
        masked_prefix_propagate_cuda
    from repro_torch.launch.fig9 import fig9_case

    masked, dense = masked_prefix_propagate_cuda, dense_propagate_cuda
    wl, stream, t_end = fig9_case(FIG9_LARGE, minutes=1)
    _reset(masked, dense)
    got, wall_g = _timed(torch, lambda: greta_run(wl, stream, t_end,
                                                  backend="cuda"))
    n_launch = masked.launches
    if n_launch == 0:
        fail(f"GRETA at {FIG9_LARGE} ev/min never launched the masked kernel")
    ham, wall_h = hamlet(wl, stream, t_end, "cuda")
    kinds_h = hold_saturated(got, ham, f"GRETA vs HAMLET at {FIG9_LARGE}")

    # the oracles per window: the row loop (host) everywhere, the numpy
    # path (the doubling) where the row loop is finite
    run_ids = ComponentContext(wl.schema, list(wl.atomic)).relevant_type_ids
    pane = pane_size_for(wl.windows)
    t0 = time.perf_counter()
    np_path, row_loop, counts = {}, {}, {}
    for g, gb in sorted(stream.partition_by_group().items()):
        ev = gb.time_slice(0, 60)
        for qi, q in enumerate(wl.atomic):
            adj, start, end_valid, _, sub = window_adjacency(
                wl.schema, q, ev, run_ids, pane=pane)
            with np.errstate(over="ignore", invalid="ignore"):
                row = ref.numpy_prefix_propagate(start[:, None], adj)[:, 0]
                total = float((row * end_valid).sum())
                dbl = None
                if math.isfinite(total) or qi in MINMAX_AGGS:
                    dbl = ops.propagate(start[:, None], adj,
                                        backend="np")[:, 0]
                key = (q.name, g, 0)
                row_loop[key] = {"COUNT(*)": total}
                np_path[key] = {"COUNT(*)": float((dbl * end_valid).sum())
                                if dbl is not None else total}
            counts[key] = (adj, start, end_valid, sub, row, dbl)
    oracle_s = time.perf_counter() - t0
    kinds = hold_saturated(got, np_path, f"GRETA cuda at {FIG9_LARGE} vs the "
                           "exact-path oracle", row_loop=row_loop)
    same = sum(1 for k, w in np_path.items()
               if math.isfinite(w["COUNT(*)"]) and got[k] == w)
    to_row = kinds.get(("finite", "row loop"), 0)
    saturated = sum(1 for w in row_loop.values()
                    if not math.isfinite(w["COUNT(*)"]))
    log(f"[baselines] fig9 at {FIG9_LARGE} ev/min: {len(stream)} events, "
        f"{len(got)} windows; GRETA cuda wall {wall_g:.3f} s ({n_launch} "
        f"masked launches), HAMLET cuda {wall_h:.3f} s; oracles on the host "
        f"{oracle_s:.3f} s")
    log(f"[baselines] GRETA cuda against the exact-path oracle: {same} "
        f"windows bitwise equal to the numpy path, {to_row} held to the row "
        f"loop (numpy path non-finite, row loop finite) within rtol "
        f"{RTOL_MAIN}, {saturated} saturated (row loop non-finite, same "
        f"non-finite windows); kinds {kinds}")
    log(f"[baselines] GRETA cuda against HAMLET cuda: kinds (GRETA, HAMLET) "
        f"{kinds_h}")
    if to_row == 0:
        fail(f"fig9 at {FIG9_LARGE}: no window was held to the row loop")

    # the MIN/MAX variant against the same rule
    wl_mm = minmax_variant(wl)
    mm_want, mm_row, mm_np = {}, {}, {}
    for (qn, g, w0), (adj, start, end_valid, sub, row, dbl) in counts.items():
        qi = int(qn[1:])
        if qi not in MINMAX_AGGS:
            continue
        agg = wl_mm.atomic[qi].aggs[-1]
        with np.errstate(over="ignore", invalid="ignore"):
            v_np = _minmax_propagate(wl.schema, agg, sub, adj, dbl, start,
                                     end_valid)
            v_row = _minmax_propagate(wl.schema, agg, sub, adj, row, start,
                                      end_valid)
        mm_np[(qn, g, w0)] = v_np
        mm_row[(qn, g, w0)] = v_row
        mm_want[((qn, g, w0), repr(agg))] = ref.exact_oracle(v_np, v_row)
    held = {}
    for K in (1, 16):
        _reset(masked, dense)
        got_mm, wall_mm = hamlet(wl_mm, stream, t_end, "cuda", K)
        launches = {"hamlet_propagate": masked.launches,
                    "hamlet_dense": dense.launches}
        if masked.launches == 0:
            fail(f"MIN/MAX at {FIG9_LARGE} (K={K}) never launched the "
                 "masked kernel")
        n_row = 0
        for (key, a), (want, src) in mm_want.items():
            gv = got_mm[key][a]
            if not (gv == want or (math.isnan(gv) and math.isnan(want))):
                fail(f"MIN/MAX at {FIG9_LARGE} K={K}: {key} {a} = {gv}, "
                     f"against {want} ({src})")
            n_row += src == "row loop"
        for key, w in ham.items():
            if not vals_equal_counts(got_mm[key], w):
                fail(f"MIN/MAX at {FIG9_LARGE} K={K}: COUNT at {key} differs "
                     "from the run without MIN/MAX")
        held[K] = n_row
        log(f"[baselines] MIN/MAX at {FIG9_LARGE} ev/min K={K}: wall "
            f"{wall_mm:.3f} s, kernel launches {launches}; {len(mm_want)} "
            f"MIN/MAX values bitwise equal to the exact-path oracle, {n_row} "
            f"of them held to the row loop (numpy path NaN); COUNT equal to "
            f"the run without MIN/MAX")
    if 0 in held.values():
        fail(f"MIN/MAX at {FIG9_LARGE}: no value was held to the row loop")
    log(f"[baselines] MIN/MAX values at {FIG9_LARGE} ev/min (numpy path / "
        f"row loop): "
        f"{ {f'{k[0]} g{k[1]}': (mm_np[k], mm_row[k]) for k in mm_np} }")
    return {"events_per_minute": FIG9_LARGE, "windows": len(got),
            "bitwise": same, "held_to_row_loop": to_row,
            "saturated": saturated, "minmax_held_to_row_loop": held[1],
            "greta_launches": n_launch}


def vals_equal_counts(a: dict, b: dict) -> bool:
    """The COUNT aggregates of two window results, equal as ``vals_equal``
    takes them (NaN equal to NaN)."""
    from repro_torch.core.engine import vals_equal

    pick = lambda r: {k: v for k, v in r.items() if k.startswith("COUNT")}
    return vals_equal(pick(a), pick(b))


def phase_obs(torch, np) -> dict:
    """The observability facade on the card: the finite cut of the main
    configuration with ``Observability()`` attached, bitwise equal to the
    run without it, its phase spans against the ``RunStats`` timers; then
    the CLI's ``--trace`` on the card."""
    from repro_torch.core.engine import HamletRuntime, vals_equal
    from repro_torch.launch import hamlet_service
    from repro_torch.obs import PHASES, Observability

    wl, stream, policy = main_config(FINITE_CUT)
    want, _, _ = _run(torch, HamletRuntime, wl, stream, policy, "cuda")
    obs = Observability()
    rt = HamletRuntime(wl, policy=policy(), backend="cuda", micro_batch=16,
                       fold_exec=True, obs=obs)
    got, wall = _timed(torch, lambda: rt.run(stream))
    if got.keys() != want.keys() or not all(vals_equal(got[k], want[k])
                                            for k in want):
        fail("obs: results with Observability() attached differ")
    log(f"[obs] {MAIN_CONFIG} at {FINITE_CUT} ev/min with Observability(): "
        f"wall {wall:.3f} s, {len(got)} windows bitwise equal to the run "
        f"without it; {len(obs.tracer)} trace events")
    totals = obs.phase_totals()
    devs = {}
    for ph in PHASES:
        span_s, stat_s = totals.get(ph, 0.0), getattr(rt.stats, f"{ph}_s")
        devs[ph] = abs(span_s - stat_s) / stat_s * 100 if stat_s else 0.0
        log(f"[obs]   {ph:8s} spans={span_s * 1e3:9.3f} ms "
            f"stats={stat_s * 1e3:9.3f} ms (dev {devs[ph]:.2f}%)")
        if devs[ph] > 5.0:
            fail(f"obs: {ph} spans deviate {devs[ph]:.2f}% from RunStats")
    audit = obs.audit.summary()
    log(f"[obs] audit: {audit}")
    if audit["decisions"] == 0:
        fail("obs: the audit log recorded no decision")
    view = obs.collect(stats=rt.stats, runtime=rt)
    log(f"[obs] collect(): {sorted(view)}")

    path = ROOT / "build" / "chip_smoke_trace.jsonl"
    path.parent.mkdir(exist_ok=True)
    hamlet_service.main(["--backend", "cuda", "--trace", str(path)])
    lines = path.read_text().splitlines()
    evs = [json.loads(ln) for ln in lines]
    if not evs or not {"plan", "execute", "finalize", "fold"} <= {
            e["name"] for e in evs if e.get("cat") == "phase"}:
        fail(f"obs: the CLI's --trace wrote no phase spans to {path}")
    log(f"[obs] CLI --trace on the card: {len(evs)} trace events in {path}")
    return {"wall_s": wall, "phase_dev_pct": devs, "audit": audit,
            "cli_trace_events": len(evs)}


# --------------------------------------------------------------------------
# the streaming layers: service, overload (load shedding), event time
# --------------------------------------------------------------------------


def _kernel_fns():
    from repro_torch.kernels.hamlet_dense import dense_propagate_cuda
    from repro_torch.kernels.hamlet_propagate import \
        masked_prefix_propagate_cuda

    return {"hamlet_propagate": masked_prefix_propagate_cuda,
            "hamlet_dense": dense_propagate_cuda}


def _launches() -> dict:
    from repro_torch.kernels.ops import kernel_launches

    return kernel_launches()


def device_split(prof, name: str) -> dict:
    """Device work launched inside the profiler ranges called ``name``
    (``record_function``): kernels and copies by count and device ms, and
    the host time of the ranges."""
    import torch

    out = {"kernels": 0, "kernel_ms": 0.0, "copies": 0, "copy_ms": 0.0,
           "host_ms": 0.0}
    for ev in prof.events():
        if ev.name != name or ev.device_type != torch.autograd.DeviceType.CPU:
            continue
        out["host_ms"] += ev.cpu_time_total / 1e3
        stack = [ev]
        while stack:
            e = stack.pop()
            for k in e.kernels:
                kind = "copies" if "memcpy" in k.name.lower() else "kernels"
                out[kind] += 1
                out["copy_ms" if kind == "copies" else "kernel_ms"] += \
                    k.duration / 1e3
            stack.extend(e.cpu_children)
    out["device_ms"] = out["kernel_ms"] + out["copy_ms"]
    return out


def busy_share(prof, wall_s: float) -> float:
    """Device activity (kernels and copies) over a wall time."""
    import torch

    dev_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
    return dev_us / 1e6 / wall_s


def record_plans(shedder) -> list:
    """Wrap ``shedder.plan`` to log every plan's kept and shed index sets."""
    log_ = []
    if shedder is None:
        return log_
    plan = shedder.plan

    def logged(pane, keep_n):
        pl = plan(pane, keep_n)
        log_.append((pl.keep.tolist(), pl.shed.tolist(), pl.witnessed))
        return pl
    shedder.plan = logged
    return log_


def accountant_state(acc) -> tuple:
    """The error accountant cell by cell, with its reports."""
    import dataclasses

    return ({k: list(v) for k, v in acc._shed.items()}, set(acc._tainted),
            acc.total_shed, acc.late_events,
            {n: dataclasses.astuple(r) for n, r in acc.report().items()})


def stream_service(torch, np, main_res) -> dict:
    """``HamletService`` on the card, fed the main configuration in arrival
    chunks of one stream minute: every window against the main phase's
    batch run on cuda (``vals_equal``); then the finite cut against the
    np service."""
    from repro_torch.core.engine import vals_equal
    from repro_torch.core.service import HamletService

    def feed(wl, stream, policy, backend):
        svc = HamletService(wl.schema, wl.queries, policy=policy(),
                            backend=backend, micro_batch=16)
        got = {}
        t0 = time.perf_counter()
        for m in range(0, int(stream.time.max()) + 1, 60):
            got.update(svc.feed(stream.time_slice(m, m + 60)))
        got.update(svc.close())
        if backend != "np":
            torch.cuda.synchronize()
        return got, svc, time.perf_counter() - t0

    wl, stream, policy = main_config()
    _reset(*_kernel_fns().values())
    got, svc, wall = feed(wl, stream, policy, "cuda")
    launches = _launches()
    want = main_res["results"]
    if got.keys() != want.keys():
        fail(f"service: window keys differ from the batch run ({len(got)} "
             f"vs {len(want)})")
    bad = [k for k in want if not vals_equal(got[k], want[k])]
    if bad:
        fail(f"service: {len(bad)} windows differ from the batch run, e.g. "
             f"{bad[0]}: {got[bad[0]]} vs {want[bad[0]]}")
    epochs = svc._t_done // svc._epoch_len
    overlap = svc.stats.events / len(stream)
    log(f"[stream] service on cuda, {MAIN_CONFIG} ({len(stream)} events) in "
        f"one-minute chunks: wall {wall:.3f} s, {len(stream) / wall:.1f} "
        f"events/s, {epochs} epochs of {svc._epoch_len} ticks, "
        f"{svc.stats.events} events replayed (overlap factor "
        f"{overlap:.3f}); {len(got)} windows, all equal to the batch run "
        f"(vals_equal); kernel launches {launches}")
    wl_c, stream_c, _ = main_config(FINITE_CUT)
    got_c, _, wall_c = feed(wl_c, stream_c, policy, "cuda")
    want_c, _, wall_np = feed(wl_c, stream_c, policy, "np")
    same, finite = hold(np, got_c, want_c, lambda a: RTOL_MAIN,
                        "service finite cut", exact_counts=True)
    if finite == 0:
        fail("service finite cut: no finite value was compared")
    log(f"[stream] service at {FINITE_CUT} ev/min ({len(stream_c)} events): "
        f"cuda {wall_c:.3f} s, np {wall_np:.3f} s; held against the np "
        f"service: {same} of {len(want_c)} windows bitwise, {finite} finite "
        f"values (COUNT exact below 2^53, rtol {RTOL_MAIN} above)")
    return {"events": len(stream), "wall_s": wall,
            "events_per_s": len(stream) / wall, "epochs": epochs,
            "replayed_events": svc.stats.events, "overlap": overlap,
            "windows": len(got), "launches": launches,
            "finite_cut_bitwise": same}


def stream_overload(torch, np) -> dict:
    """``OverloadRuntime`` on the card on fig_overload's SLO-control stream:
    fixed shedding against np (shed sets and error reports bitwise, windows
    held), then the live controller at 2x the calibrated cuda capacity,
    each policy run once more under the profiler for the device's busy
    share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import HamletRuntime
    from repro_torch.launch.fig_overload import (detection_recall,
                                                 fragmented_stream,
                                                 slo_control_case)
    from repro_torch.overload import OverloadConfig, OverloadRuntime

    wl, stream, t_end = slo_control_case()
    log(f"[stream] overload: fig_overload slo_control, {len(stream)} events, "
        f"{len(wl.queries)} queries, t_end {t_end}")

    def run(backend, **cfg):
        ort = OverloadRuntime(wl, OverloadConfig(**cfg), backend=backend)
        plans = record_plans(ort.shedder)
        t0 = time.perf_counter()
        res = ort.run(stream, t_end)
        ort.shutdown()
        if backend != "np":
            torch.cuda.synchronize()
        return res, ort, plans, time.perf_counter() - t0

    counts = lambda ort: [(p.t0, p.offered, p.admitted, p.shed, p.shed_ratio)
                          for p in ort.metrics.panes]
    launches = {name: 0 for name in _kernel_fns()}
    fixed = []
    for policy in ("drop_tail", "random", "benefit_weighted"):
        want, ref, ref_plans, wall_np = run("np", shed_policy=policy,
                                            fixed_shed=0.5)
        variants = [{"micro_batch": 1}, {"micro_batch": 4}]
        if policy == "benefit_weighted":
            variants.append({"micro_batch": 4, "pipeline_flush": True})
        for extra in variants:
            _reset(*_kernel_fns().values())
            got, ort, plans, wall = run("cuda", shed_policy=policy,
                                        fixed_shed=0.5, **extra)
            n = _launches()
            for name, k in n.items():
                launches[name] += k
            what = f"overload {policy} {extra}"
            if plans != ref_plans:
                fail(f"{what}: shed sets differ from np")
            if accountant_state(ort.accountant) != accountant_state(
                    ref.accountant):
                fail(f"{what}: the error accountant differs from np")
            if counts(ort) != counts(ref):
                fail(f"{what}: per-pane admission differs from np")
            same, _ = hold(np, got, want, lambda a: RTOL_MAIN, what,
                           exact_counts=True)
            s = ort.metrics.summary()
            fixed.append({"policy": policy, **extra, "wall_s": wall,
                          "shed_frac": s["shed_frac"],
                          "p50_proc_ms": s["p50_proc_ms"],
                          "p99_proc_ms": s["p99_proc_ms"], "bitwise": same,
                          "launches": n})
            log(f"[stream] {what}: wall {wall:.3f} s (np {wall_np:.3f}); "
                f"{len(plans)} shed plans and the accountant's "
                f"{len(ort.accountant._shed)} cells and reports equal to np; "
                f"shed {s['shed_frac']:.4f}; pane proc p50 "
                f"{s['p50_proc_ms']:.3f} ms p99 {s['p99_proc_ms']:.3f} ms; "
                f"{same} of {len(want)} windows bitwise; launches {n}")
    if sum(launches.values()) == 0:
        fail("overload: no kernel was launched")

    # the live controller at 2x the capacity calibrated on the card
    rt = HamletRuntime(wl, backend="cuda")
    truth, dt = _timed(torch, lambda: rt.run(stream, t_end))
    capacity = len(stream) / dt
    frag = fragmented_stream()
    _, dt_frag = _timed(torch, lambda: HamletRuntime(wl, backend="cuda").run(
        frag, 60))
    cap_frag = len(frag) / dt_frag
    offered_x = 2.0
    tick_seconds = (len(stream) / t_end) / (offered_x * capacity)
    slo_ms = rt.pane * tick_seconds * 1e3
    budget = max(1, int(cap_frag * slo_ms / 1e3))
    log(f"[stream] calibration on cuda: capacity {capacity:.1f} events/s, "
        f"fragmented {cap_frag:.1f} events/s; offered {offered_x}x: tick "
        f"{tick_seconds * 1e3:.4f} ms, SLO {slo_ms:.4f} ms a pane of "
        f"{rt.pane} ticks, admission cap {budget} events a pane")
    live = {}
    for policy in ("benefit_weighted", "none"):
        cfg = OverloadConfig(slo_ms=slo_ms, shed_policy=policy,
                             tick_seconds=tick_seconds,
                             pane_budget_events=budget, min_burst_keep=0.1)
        ort = OverloadRuntime(wl, cfg, backend="cuda")
        _reset(*_kernel_fns().values())
        res, wall = _timed(torch, lambda: ort.run(stream, t_end))
        n = _launches()
        # the same run again under the profiler, for the device's share
        again = OverloadRuntime(wl, cfg, backend="cuda")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall_p = _timed(torch, lambda: again.run(stream, t_end))
        busy = busy_share(prof, wall_p)
        for name, k in n.items():
            launches[name] += k
        s = ort.metrics.summary()
        recall, n_true = detection_recall(truth, res)
        live[policy] = dict(s, slo_ms=slo_ms, recall=recall, wall_s=wall,
                            busy_share=busy, launches=n)
        log(f"[stream] live controller, {policy}: {s['panes']} panes, pane "
            f"proc p50 {s['p50_proc_ms']:.4f} ms p99 {s['p99_proc_ms']:.4f} "
            f"ms ({s['p99_proc_ms'] / slo_ms:.3f}x SLO {slo_ms:.4f} ms), "
            f"end-to-end p99 {s['p99_lat_ms']:.4f} ms, shed "
            f"{s['shed_frac']:.4f}, mean shed ratio "
            f"{s['mean_shed_ratio']:.4f}, recall {recall:.4f} over {n_true} "
            f"windows, wall {wall:.3f} s, launches {n}; profiled again: "
            f"wall {wall_p:.3f} s, device busy {busy:.5f} of it, pane proc "
            f"p50 {again.metrics.summary()['p50_proc_ms']:.4f} ms")
    # the SLO is reported, not gated (the controller follows a shared
    # host's wall clock); shedding must still cut the tail it is there for
    shed_p99, none_p99 = (live[p]["p99_lat_ms"]
                          for p in ("benefit_weighted", "none"))
    if not shed_p99 < none_p99:
        fail(f"overload: end-to-end p99 with benefit_weighted shedding "
             f"{shed_p99:.4f} ms is not below the unshed run's "
             f"{none_p99:.4f} ms at {offered_x}x capacity")
    return {"events": len(stream), "fixed": fixed, "capacity": capacity,
            "capacity_fragmented": cap_frag, "offered_x": offered_x,
            "live": live, "launches": launches}


def stream_eventtime(torch, np) -> dict:
    """``EventTimeRuntime`` on the card on fig_disorder's ridesharing row,
    speculative and buffered, held against the in-order cuda runtime and
    the in-order np runtime (the cuda run itself first held against np); the
    speculative run again under the profiler for ``ops.fold_stacked``'s
    device time; then ``HamletService(eventtime=...)`` on the same
    stream."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.engine import HamletRuntime
    from repro_torch.core.service import HamletService
    from repro_torch.eventtime import EventTimeRuntime
    from repro_torch.kernels import ops
    from repro_torch.launch.fig_disorder import (CHUNK, disorder_case,
                                                 event_time_config)

    wl, base, ds, t_end = disorder_case()
    truth, wall_t = _timed(torch, lambda: HamletRuntime(
        wl, backend="cuda").run(base, t_end))
    t0 = time.perf_counter()
    truth_np = HamletRuntime(wl, backend="np").run(base, t_end)
    wall_np = time.perf_counter() - t0
    rtol = lambda a: RTOL_SUM
    same, finite = hold(np, truth, truth_np, rtol, "event time in-order cuda",
                        exact_counts=True)
    log(f"[stream] event time: fig_disorder ridesharing, {len(base)} events, "
        f"{len(wl.queries)} queries, bounded_skew fraction 0.2, max lateness "
        f"{ds.max_lateness()}, chunk {CHUNK}; in-order cuda run "
        f"{wall_t:.3f} s, {len(truth)} windows, held against the in-order np "
        f"run ({wall_np:.3f} s): {same} windows bitwise, {finite} finite "
        f"values (COUNT exact below 2^53, rtol {RTOL_SUM})")
    launches = {name: 0 for name in _kernel_fns()}

    def held(got, what):
        """Hold ``got`` against the in-order cuda run and the np run."""
        same, _ = hold(np, got, truth, rtol, what, exact_counts=True)
        same_np, _ = hold(np, got, truth_np, rtol, f"{what} (against np)",
                          exact_counts=True)
        return same, same_np

    def drive(speculative):
        et = EventTimeRuntime(wl, event_time_config(ds, speculative),
                              backend="cuda")
        storms = []
        revise = et._revise

        def counted(dirty):
            m = et.metrics
            n0 = m.amendments + m.noop_revisions
            recs = revise(dirty)
            if m.amendments + m.noop_revisions > n0:
                storms.append(m.amendments + m.noop_revisions - n0)
            return recs
        et._revise = counted
        got, wall = _timed(torch, lambda: et.run_disordered(
            ds.base, ds.order, chunk=CHUNK, t_end=t_end))
        return et, got, wall, storms

    modes = {}
    for speculative in (True, False):
        _reset(*_kernel_fns().values())
        et, got, wall, storms = drive(speculative)
        n = _launches()
        for name, k in n.items():
            launches[name] += k
        mode = "speculate" if speculative else "buffer"
        same, same_np = held(got, f"event time {mode}")
        m = et.metrics.summary()
        modes[mode] = dict(m, wall_s=wall, bitwise=same,
                           bitwise_np=same_np, storms=len(storms),
                           max_storm=max(storms, default=0),
                           window_folds=et.rt.fold_exec.window_folds,
                           launches=n)
        log(f"[stream] event time {mode}: wall {wall:.3f} s; against the "
            f"in-order cuda run {same} of {len(truth)} windows bitwise, "
            f"against np {same_np} (COUNT exact below 2^53, rtol "
            f"{RTOL_SUM}); "
            f"amendments {m['amendments']}, noop revisions "
            f"{m['noop_revisions']}, revision storms {len(storms)} (windows "
            f"re-folded: max {max(storms, default=0)}, total "
            f"{sum(storms)}), emission lag p50 {m['p50_emit_lag']} p99 "
            f"{m['p99_emit_lag']} ticks, fold_exec.window_folds "
            f"{et.rt.fold_exec.window_folds}; launches {n}")
    if modes["speculate"]["amendments"] == 0:
        fail("event time: the speculative run never revised a window")

    # fold_stacked under the profiler, in the speculative run's storms
    orig = ops.fold_stacked
    calls = []

    def traced(u0, Ms, **kw):
        with record_function("fold_stacked"):
            out = orig(u0, Ms, **kw)
        calls.append(tuple(np.shape(Ms)))
        return out
    ops.fold_stacked = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            et, got, wall_p, _ = drive(True)
    finally:
        ops.fold_stacked = orig
    held(got, "event time speculate (profiled)")
    split = device_split(prof, "fold_stacked")
    matmuls = sum(s[1] for s in calls)
    fold = dict(split, calls=len(calls), matmul_launches=matmuls,
                windows=sum(s[0] for s in calls), wall_s=wall_p)
    log(f"[stream] ops.fold_stacked in the speculative run (profiled, wall "
        f"{wall_p:.3f} s): {len(calls)} calls over {fold['windows']} window "
        f"chains, {matmuls} batched matmul launches; device time in its "
        f"ranges {split['device_ms']:.4f} ms ({split['kernel_ms']:.4f} ms "
        f"in {split['kernels']} kernels, {split['copy_ms']:.4f} ms in "
        f"{split['copies']} copies), host time in its ranges "
        f"{split['host_ms']:.3f} ms")

    # the service's event-time mode on the same disordered stream
    svc = HamletService(wl.schema, wl.queries, backend="cuda",
                        eventtime=event_time_config(ds, True))
    _reset(*_kernel_fns().values())
    t0 = time.perf_counter()
    for ch in ds.chunks(CHUNK):
        svc.feed(ch)
    svc.close()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    n = _launches()
    for name, k in n.items():
        launches[name] += k
    same, same_np = held(svc.results, "service event time")
    if svc.expired_late:
        fail(f"service event time: {svc.expired_late} events expired")
    log(f"[stream] service event time: wall {wall_s:.3f} s, "
        f"{len(svc.revisions)} revision records; {same} of {len(truth)} "
        f"windows bitwise against the in-order cuda run, {same_np} against "
        f"np; launches {n}")
    return {"events": len(base), "in_order_bitwise_np": same, "modes": modes,
            "fold_stacked": fold,
            "service": {"wall_s": wall_s, "revisions": len(svc.revisions),
                        "bitwise": same, "bitwise_np": same_np},
            "launches": launches}


def phase_stream(torch, np, main_res) -> dict:
    """The streaming layers on the card: the service, the overload runtime
    (fixed shedding against np, then the live controller's per-pane
    latency) and the event-time runtime.  Each part counts its kernel
    launches from zero; the phase fails unless both kernels launched."""
    out = {"service": stream_service(torch, np, main_res),
           "overload": stream_overload(torch, np),
           "eventtime": stream_eventtime(torch, np)}
    total = {name: sum(out[p]["launches"][name] for p in out)
             for name in _kernel_fns()}
    for part, r in out.items():
        if sum(r["launches"].values()) == 0:
            fail(f"stream {part}: no kernel was launched")
    for name, k in total.items():
        if k == 0:
            fail(f"stream phase never launched {name}")
    log(f"[stream] kernel launches over the phase: {total}")
    out["launches"] = total
    return out


# --------------------------------------------------------------------------
# sharded service and serving tier
# --------------------------------------------------------------------------

RTOL_SHARD = 1e-12      # non-COUNT values, N-shard / serving vs 1-shard
SHARDS = 4              # the shards phase's shard count (one replica each)
# the shards phase runs fig_shard_scale's quick mode (2 minutes, 27,475
# events a replica): in full mode (6 minutes, 82,603 a replica, 330,412 in
# all) the phase took about 95-120 s on an H100 host, past its ~60 s
# budget (PERF.md, section 6); every check is the same in both modes
SHARDS_QUICK = True


def hold_rule(np, got: dict, want: dict, what: str) -> int:
    """The sharded service's and serving tier's rule against a run whose
    flushes fuse other panes: equal keys and non-finite pattern, COUNT
    exact below 2^53, every other value within ``RTOL_SHARD``.  Returns
    the number of bitwise-equal windows (printed beside)."""
    same, _ = hold(np, got, want, lambda a: RTOL_SHARD, what,
                   exact_counts=True)
    return same


def _drive_shards(torch, svc, stream) -> dict:
    """Feed ``stream`` pane by pane into a sharded service, close it and
    read its results and timings (device synced)."""
    t_hi = int(stream.time.max()) + 1
    t0 = time.perf_counter()
    for c0 in range(0, t_hi, svc.pane):
        svc.ingest(stream.time_slice(c0, c0 + svc.pane))
    svc.close()
    res = svc.results()
    if svc.device is not None:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    col = svc.collect()
    return {"results": res, "wall_s": wall,
            "events_per_s": len(stream) / wall,
            "router_busy_s": svc.router_busy_s,
            "shard_busy_s": [s["busy_s"] for s in col["shards"]],
            "p99_proc_ms": [s["overload"]["p99_proc_ms"]
                            for s in col["shards"]],
            "executor_launches": [s["executor_launches"]
                                  for s in col["shards"]],
            "kernel_launches": [s["kernel_launches"] for s in col["shards"]],
            "foreign_modules": [s["foreign_modules"] for s in col["shards"]],
            "drive_mode": col["router"]["drive_mode"]}


def _shard_line(name: str, r: dict, n_events: int, same: int,
                n_windows: int) -> None:
    log(f"[shards] {name}: wall {r['wall_s']:.3f} s, "
        f"{r['events_per_s']:.1f} events/s ({n_events} events), router busy "
        f"{r['router_busy_s']:.3f} s, shard busy "
        f"{[round(b, 3) for b in r['shard_busy_s']]} s, p99 proc_ms "
        f"{[round(p, 3) for p in r['p99_proc_ms']]}, {same} of {n_windows} "
        f"windows bitwise against np (COUNT exact below 2^53, rtol "
        f"{RTOL_SHARD} above), cpus {os.cpu_count()}")


def phase_shards(torch, np) -> dict:
    """The sharded service on the card: fig_shard_scale's configuration
    replicated onto ``SHARDS`` shards (one replica each, pinned), held
    against the np 1-shard run; the 1-shard cuda run, then the serial,
    thread and process drives; a rebalance; the predicate variant in
    process mode (the masked kernel in the worker processes); the flash
    crowd's isolation (printed); and the pane-batch sharding hook on the
    main configuration's finite cut."""
    from repro_torch.core.engine import HamletRuntime, vals_equal
    from repro_torch.distributed.sharding import pane_bucket_shards
    from repro_torch.launch import fig_shard_scale as F

    out = {"cpus": os.cpu_count()}
    fns = _kernel_fns()

    # the sharding hook: bitwise, with more launches
    wl_c, stream_c, policy = main_config(FINITE_CUT)
    runs = {}
    for split in (None, 3):
        _reset(*fns.values())
        rt = HamletRuntime(
            wl_c, policy=policy(), backend="cuda", micro_batch=16,
            shard_slices=None if split is None
            else (lambda nb: pane_bucket_shards(nb, split)))
        runs[split] = (rt.run(stream_c), _launches(), rt.executor.launches)
    (whole, l_whole, e_whole), (cut, l_cut, e_cut) = runs[None], runs[3]
    if whole.keys() != cut.keys() or any(
            not vals_equal(cut[k], whole[k]) for k in whole):
        fail("shard_slices: the split run is not bitwise the whole run")
    if not sum(l_cut.values()) > sum(l_whole.values()):
        fail(f"shard_slices: no more launches split ({l_cut}) than whole "
             f"({l_whole})")
    log(f"[shards] shard_slices=pane_bucket_shards(nb, 3) on the "
        f"{FINITE_CUT} ev/min cut: {len(cut)} windows bitwise equal to the "
        f"unsplit run; kernel launches {l_cut} against {l_whole} (executor "
        f"{e_cut} against {e_whole})")
    out["shard_slices"] = {"launches": l_cut, "unsplit_launches": l_whole}

    wl = F.workload()
    base = F.base_stream(SHARDS_QUICK)
    stream = F.replicated(base, SHARDS)
    log(f"[shards] fig_shard_scale "
        f"{'quick' if SHARDS_QUICK else 'full'} mode: {len(base)} events a "
        f"replica, {SHARDS} replicas ({len(stream)} events), "
        f"{len(wl.queries)} queries, pane 5, K={F.MICRO_BATCH}"
        + ("; cut from the full mode's 6 minutes a replica to 2, to keep "
           "the phase near 60 s" if SHARDS_QUICK else ""))
    want_run = _drive_shards(torch, F.service(wl, 1, backend="np"), stream)
    want = want_run["results"]
    log(f"[shards] np 1-shard: wall {want_run['wall_s']:.3f} s, "
        f"{want_run['events_per_s']:.1f} events/s, {len(want)} windows")
    out["np_1"] = {k: v for k, v in want_run.items() if k != "results"}

    for name, n, parallel in (("cuda 1-shard", 1, False),
                              (f"cuda {SHARDS}-shard serial", SHARDS, False),
                              (f"cuda {SHARDS}-shard thread", SHARDS, True),
                              (f"cuda {SHARDS}-shard process", SHARDS,
                               "process")):
        svc = F.service(wl, n, backend="cuda", parallel=parallel)
        _reset(*fns.values())
        r = _drive_shards(torch, svc, stream)
        launches = _launches()
        same = hold_rule(np, r["results"], want, name)
        _shard_line(name, r, len(stream), same, len(want))
        if parallel == "process":
            for s, (k, mods) in enumerate(zip(r["kernel_launches"],
                                              r["foreign_modules"])):
                if sum(k.values()) == 0:
                    fail(f"{name}: shard process {s} launched no kernel")
                if mods:
                    fail(f"{name}: shard process {s} imported {mods[:5]}")
            launches = {kn: sum(k[kn] for k in r["kernel_launches"])
                        for kn in fns}
            log(f"[shards] {name}: each worker process's launches "
                f"{r['kernel_launches']}, no jax or JAX-package module in "
                "any of them")
        elif sum(r["executor_launches"]) != sum(launches.values()):
            fail(f"{name}: the shards' executors launched "
                 f"{r['executor_launches']} (sum "
                 f"{sum(r['executor_launches'])}), the kernels counted "
                 f"{launches}")
        else:
            log(f"[shards] {name}: the shards' executor launches "
                f"{r['executor_launches']} add up to the kernels' counters "
                f"{launches}")
        if sum(launches.values()) == 0:
            fail(f"{name}: no kernel was launched")
        out[name] = dict({k: v for k, v in r.items() if k != "results"},
                         launches=launches, bitwise=same,
                         windows=len(want))

    # one rebalance (serial): exact against the same run without it
    svc = F.service(wl, SHARDS, backend="cuda")
    t_hi = int(stream.time.max()) + 1
    boundary = None
    t0 = time.perf_counter()
    for c0 in range(0, t_hi, svc.pane):
        svc.ingest(stream.time_slice(c0, c0 + svc.pane))
        if boundary is None and c0 >= t_hi // 2:
            boundary = svc.plan_rebalance(0, 1)
    svc.close()
    moved = svc.results()
    torch.cuda.synchronize()
    serial = out[f"cuda {SHARDS}-shard serial"]
    if svc.placement.overrides.get(0) != 1 or svc._moves:
        fail("rebalance: the move of group 0 never committed")
    same = hold_rule(np, moved, want, "rebalance against np")
    log(f"[shards] rebalance of group 0 from shard 0 to 1 at tick "
        f"{boundary} (serial, {time.perf_counter() - t0:.3f} s): {same} of "
        f"{len(want)} windows bitwise against np (the run without it: "
        f"{serial['bitwise']})")
    out["rebalance"] = {"boundary": boundary, "bitwise": same}

    # the predicate variant: the masked kernel in the worker processes
    wl_p = F.workload(pred_attr="speed")
    want_p = _drive_shards(torch, F.service(wl_p, 1, backend="np"),
                           stream)["results"]
    r = _drive_shards(torch, F.service(wl_p, SHARDS, backend="cuda",
                                       parallel="process"), stream)
    same = hold_rule(np, r["results"], want_p, "predicate variant")
    for s, k in enumerate(r["kernel_launches"]):
        if k["hamlet_propagate"] == 0 or k["hamlet_dense"] == 0:
            fail(f"predicate variant: shard process {s} launched {k}")
    if any(r["foreign_modules"]):
        fail(f"predicate variant: a worker imported {r['foreign_modules']}")
    _shard_line(f"predicate variant, cuda {SHARDS}-shard process", r,
                len(stream), same, len(want_p))
    log(f"[shards] predicate variant: each worker process's launches "
        f"{r['kernel_launches']}")
    out["predicate_process"] = dict(
        {k: v for k, v in r.items() if k != "results"}, bitwise=same,
        windows=len(want_p), launches={
            kn: sum(k[kn] for k in r["kernel_launches"]) for kn in fns})

    # flash isolation (printed, not gated)
    flash = F.replicated(base, SHARDS,
                         flash_base=F.base_stream(SHARDS_QUICK, flash=True))
    r = _drive_shards(torch, F.service(wl, SHARDS, backend="cuda"), flash)
    quiet = serial["p99_proc_ms"]
    ratio = [r["p99_proc_ms"][s] / quiet[s] if quiet[s] else float("nan")
             for s in range(SHARDS)]
    log(f"[shards] flash crowd on shard 0 ({len(flash)} events): p99 "
        f"proc_ms {[round(p, 3) for p in r['p99_proc_ms']]} against "
        f"{[round(p, 3) for p in quiet]} without it (x"
        f"{[round(x, 3) for x in ratio]}; SLO {F.SLO_MS} ms; not gated)")
    out["flash"] = {"p99_proc_ms": r["p99_proc_ms"], "ratio": ratio}
    total = {kn: sum(out[k]["launches"][kn] for k in out
                     if isinstance(out[k], dict) and "launches" in out[k])
             for kn in fns}
    for kn, n in total.items():
        if n == 0:
            fail(f"shards phase never launched {kn}")
    out["launches"] = total
    return out


def phase_serve(torch, np) -> dict:
    """The serving tier on the card, on fig_shard_scale's one-replica
    stream: 32 trickle sessions with an inline pump against
    ``OverloadRuntime.run`` on the merged stream; the same sessions paced
    on threads with the background pump (per-session delivery latency);
    the sharded adapter with 2 shards on the thread drive; and a
    ``ServingServer`` with 8 ``ServingClient``s over loopback."""
    import threading

    from repro_torch.launch import fig_shard_scale as F
    from repro_torch.overload import OverloadConfig, OverloadRuntime
    from repro_torch.serve import (ServingClient, ServingFrontend,
                                   ServingServer)
    from repro_torch.shardsvc import ShardServiceConfig

    fns = _kernel_fns()
    wl = F.workload()
    stream = F.base_stream()
    gpt = F.GROUPS_PER_TENANT
    cfg = lambda: OverloadConfig(shed_policy="none",            # noqa: E731
                                 micro_batch=F.MICRO_BATCH)
    out = {}

    def sync_run(backend):
        ort = OverloadRuntime(wl, cfg(), backend=backend)
        t0 = time.perf_counter()
        res = ort.run(stream)
        ort.shutdown()
        if backend != "np":
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    want_np, wall_np = sync_run("np")
    _reset(*fns.values())
    want, wall_sync = sync_run("cuda")
    same = hold_rule(np, want, want_np, "OverloadRuntime cuda against np")
    log(f"[serve] OverloadRuntime.run on the merged stream ({len(stream)} "
        f"events, K={F.MICRO_BATCH}): cuda {wall_sync:.3f} s "
        f"({len(stream) / wall_sync:.1f} events/s; launches {_launches()}), "
        f"np {wall_np:.3f} s; {same} of {len(want)} windows bitwise against "
        "np")
    out["sync"] = {"wall_s": wall_sync, "events_per_s": len(stream) /
                   wall_sync, "bitwise_np": same}

    parts = F.session_parts(stream, F.N_SESSIONS)

    def frontend(**kw):
        kw.setdefault("overload", cfg())
        return ServingFrontend(wl, np_backend="cuda", groups_per_tenant=gpt,
                               **kw)

    # 32 sessions, inline pump: round-robin one pane of each session
    fe = frontend()
    hs = [fe.open_session(tenant=t) for t, _ in parts]
    t_hi = int(stream.time.max()) + 1
    _reset(*fns.values())
    t0 = time.perf_counter()
    for c0 in range(0, t_hi, fe.pane):
        for h, (_, part) in zip(hs, parts):
            h.submit(part.time_slice(c0, c0 + fe.pane))
            h.advance_to(c0 + fe.pane)
        fe.pump()
    for h in hs:
        h.close()
    got = fe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    same = hold_rule(np, got, want, "serving inline pump")
    if sum(launches.values()) == 0:
        fail("serving inline pump: no kernel was launched")
    log(f"[serve] {F.N_SESSIONS} sessions, inline pump: {wall:.3f} s "
        f"({len(stream) / wall:.1f} events/s, {wall_sync / wall:.3f}x the "
        f"synchronous run's rate); {same} of {len(want)} windows bitwise "
        f"against OverloadRuntime.run (COUNT exact, rtol {RTOL_SHARD}); "
        f"launches {launches}")
    out["inline"] = {"wall_s": wall, "events_per_s": len(stream) / wall,
                     "bitwise": same, "launches": launches}
    in_process = got

    # the same sessions paced on threads with the background pump
    rate = 15_000                        # offered events/s, all sessions
    fe = frontend()
    hs = [fe.open_session(tenant=t) for t, _ in parts]
    duration = len(stream) / rate
    _reset(*fns.values())
    fe.start(interval_s=0.001)
    w0 = time.perf_counter()

    def trickle(h, part):
        steps = range(0, int(part.time.max()) + 1 if len(part) else 0,
                      fe.pane)
        period = duration / max(1, len(steps))
        for k, c0 in enumerate(steps):
            lag = w0 + (k + 1) * period - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            h.submit(part.time_slice(c0, c0 + fe.pane))
            h.advance_to(c0 + fe.pane)
        h.close()

    ths = [threading.Thread(target=trickle, args=(h, part))
           for h, (_, part) in zip(hs, parts)]
    for th in ths:
        th.start()
    for th in ths:
        th.join()
    got = fe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    launches = _launches()
    same = hold_rule(np, got, want, "serving background pump")
    lat = [np.array([d.latency_ms for d in h.poll() if d.kind != "retract"])
           for h in hs]
    p50 = [float(np.percentile(x, 50)) if x.size else float("nan")
           for x in lat]
    p99 = [float(np.percentile(x, 99)) if x.size else float("nan")
           for x in lat]
    allv = np.concatenate(lat)
    if sum(launches.values()) == 0:
        fail("serving background pump: no kernel was launched")
    log(f"[serve] {F.N_SESSIONS} sessions paced at {rate} events/s on "
        f"threads, background pump: wall {wall:.3f} s, {allv.size} "
        f"deliveries; delivery latency p50 {np.percentile(allv, 50):.3f} ms "
        f"p99 {np.percentile(allv, 99):.3f} ms over all; per session p50 "
        f"{min(p50):.3f}-{max(p50):.3f} ms, p99 {min(p99):.3f}-"
        f"{max(p99):.3f} ms; {same} of {len(want)} windows bitwise; "
        f"launches {launches}")
    out["paced"] = {"rate": rate, "wall_s": wall, "deliveries": allv.size,
                    "p50_ms": float(np.percentile(allv, 50)),
                    "p99_ms": float(np.percentile(allv, 99)),
                    "session_p50_ms": p50, "session_p99_ms": p99,
                    "bitwise": same, "launches": launches}

    # the sharded adapter, 2 shards on the thread drive
    fe = frontend(backend="sharded", overload=None,
                  shard_cfg=ShardServiceConfig(
                      n_shards=2, groups_per_tenant=gpt, admission="none",
                      parallel=True, overload=cfg()))
    placement = fe._backend.svc.placement
    for g in range(int(stream.group.max()) + 1):     # tenant t on shard t % 2
        placement.override(g, (g // gpt) % 2)
    hs = [fe.open_session(tenant=t) for t, _ in parts]
    _reset(*fns.values())
    t0 = time.perf_counter()
    for c0 in range(0, t_hi, fe.pane):
        for h, (_, part) in zip(hs, parts):
            h.submit(part.time_slice(c0, c0 + fe.pane))
            h.advance_to(c0 + fe.pane)
        fe.pump()
    for h in hs:
        h.close()
    got = fe.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    shard_launches = [s["executor_launches"]
                      for s in fe._backend.svc.collect()["shards"]]
    same = hold_rule(np, got, want, "sharded serving adapter")
    if fe._backend.svc.backend != "cuda" or sum(launches.values()) == 0:
        fail("sharded serving adapter: the shards did not launch kernels")
    if min(shard_launches) == 0 or sum(shard_launches) != sum(
            launches.values()):
        fail(f"sharded serving adapter: shard launches {shard_launches}, "
             f"kernel counters {launches}")
    log(f"[serve] sharded adapter, 2 shards, thread drive: {wall:.3f} s "
        f"({len(stream) / wall:.1f} events/s); {same} of {len(want)} windows "
        f"bitwise; the shards' launches {shard_launches} are the kernels' "
        f"{launches}")
    out["sharded"] = {"wall_s": wall, "bitwise": same, "launches": launches}

    # a server and 8 clients over loopback
    parts8 = F.session_parts(stream, F.TRANSPORT_SESSIONS)
    fds = len(os.listdir("/proc/self/fd"))
    threads_before = set(threading.enumerate())
    fe = frontend()
    srv = ServingServer(fe)
    host, port = srv.start()
    ends = {}
    ready = threading.Barrier(len(parts8))

    def client(i, tenant, part):
        c = ServingClient(host, port, tenant=tenant)
        ready.wait(timeout=60)
        for c0 in range(0, t_hi, fe.pane):
            c.submit(part.time_slice(c0, c0 + fe.pane))
            c.advance_to(c0 + fe.pane)
        c.close()
        ends[i] = (tenant, c.wait_end(timeout=300))
        c.shutdown()

    _reset(*fns.values())
    t0 = time.perf_counter()
    ths = [threading.Thread(target=client, args=(i, t, p))
           for i, (t, p) in enumerate(parts8)]
    for th in ths:
        th.start()
    deadline = time.perf_counter() + 300
    while True:
        sess = fe.summary()["sessions"]
        if len(sess) >= len(parts8) and all(v["closed"]
                                            for v in sess.values()):
            break
        if time.perf_counter() > deadline:
            fail("loopback: the sessions never closed")
        time.sleep(0.005)
    srv.drain()
    for th in ths:
        th.join(timeout=300)
    srv.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    wire = srv.summary()
    same = 0
    for i, (tenant, end) in sorted(ends.items()):
        sub = {k: v for k, v in in_process.items() if k[1] // gpt == tenant}
        same += hold_rule(np, end, sub, f"loopback client {i}")
    if len(ends) != len(parts8):
        fail(f"loopback: {len(ends)} of {len(parts8)} clients got END")
    left = [t for t in threading.enumerate()
            if t not in threads_before and t.is_alive()]
    if left or len(os.listdir("/proc/self/fd")) > fds:
        fail(f"loopback: threads {left} or fds left after stop()")
    if sum(launches.values()) == 0:
        fail("loopback: no kernel was launched")
    log(f"[serve] ServingServer + {len(parts8)} ServingClients over "
        f"loopback: {wall:.3f} s, frames in {wire['frames_in']} out "
        f"{wire['frames_out']}, bytes in {wire['bytes_in']} out "
        f"{wire['bytes_out']}; every END equal to the in-process run's "
        f"windows ({same} bitwise); no thread or fd left; launches "
        f"{launches}")
    out["loopback"] = {"wall_s": wall, "bitwise": same,
                       "launches": launches, "frames_in": wire["frames_in"]}
    total = {kn: sum(out[k]["launches"][kn] for k in out
                     if "launches" in out[k]) for kn in fns}
    out["launches"] = total
    return out


# --------------------------------------------------------------------------
# the LM substrate: configs, models, the token serving engine, launch.serve
# --------------------------------------------------------------------------

LM_ARCH = "gemma2-2b"           # launch.serve's default architecture
LM_BATCH, LM_PROMPT, LM_GEN = 4, 6_144, 32
# 6,144 > window + chunk (4,096 + 512): the banded local prefill, the
# chunked global prefill and, decoding token 6,144, the ring's wrap-around
RTOL_LM_DEVICE = 1e-4   # f32 logits, card against the CPU (smoke size)
RTOL_LM_DECODE = 2e-3   # prefill + decode against forward, f32 (the
                        # reference's test_smoke_decode_consistency bound)
RTOL_LM_BF16 = 0.12     # the same at full width in bf16: 26 layers of
                        # bf16 roundings on two paths (measured 0.0579 on
                        # an H100 80GB HBM3; the bound is twice that)
PEAK_BYTES_S = 3.35e12  # H100 SXM memory rate (data sheet)


def _lm_err(np, got, want) -> float:
    g = got.detach().float().cpu().numpy()
    w = want.detach().float().cpu().numpy()
    if g.shape != w.shape:
        fail(f"lm: shapes {g.shape} != {w.shape}")
    return float(np.max(np.abs(g - w) / (1.0 + np.abs(w))))


def _lm_inputs(np, cfg, T: int, n_dec: int, seed: int = 3):
    """numpy batches over T positions for one smoke architecture, as the
    port's CPU tests build them: ``full`` (all T), ``pre`` (the first
    T - n_dec) and ``dec[j]`` (position T - n_dec + j)."""
    B = 2
    rng = np.random.default_rng(seed)
    n_vis = 4 if cfg.frontend == "patches" else 0
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    full = {"tokens": toks[:, :T - n_vis]}
    pre = {"tokens": toks[:, :T - n_vis - n_dec]}
    dec = [{"token": toks[:, T - n_vis - n_dec + j][:, None],
            "pos": np.full((B,), T - n_dec + j, np.int32)}
           for j in range(n_dec)]
    if cfg.enc_dec:
        full["frames"] = pre["frames"] = rng.standard_normal(
            (B, T - n_dec, cfg.d_model)).astype(np.float32)
    if n_vis:
        full["patch_embeds"] = pre["patch_embeds"] = rng.standard_normal(
            (B, n_vis, cfg.d_model)).astype(np.float32)
    if cfg.mrope_sections:
        P = np.broadcast_to(np.arange(T), (3, B, T)).astype(np.int32)
        full["positions"] = P
        pre["positions"] = P[:, :, :T - n_dec]
        for j, d in enumerate(dec):
            d["positions"] = P[:, :, T - n_dec + j:T - n_dec + j + 1]
    return full, pre, dec


def _on(torch, np, batch: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def lm_smoke(torch, np, dev) -> dict:
    """All ten architectures at ``reduce_for_smoke`` size in f32: the card
    against the port on the CPU with the same weights (forward logits),
    and on the card prefill S + decode token S against the forward over
    S + 1; then h2o-danube's smoke ``ServeEngine`` (tests/test_serve.py's
    setup) gives the same greedy tokens on the card as on the CPU."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
    from repro_torch.models import LM, decode_fn, init_cache, prefill_fn
    from repro_torch.serve import ServeEngine

    cpu = torch.device("cpu")
    S = 16
    out = {}
    for arch in ARCHS:
        cfg = replace(reduce_for_smoke(get_config(arch)), dtype="float32",
                      capacity_factor=8.0)
        host = LM(cfg, device=cpu, seed=0)
        card = copy.deepcopy(host).to(dev)
        full, pre, dec = _lm_inputs(np, cfg, S + 1, 1)
        with torch.inference_mode():
            want, _, _ = host(_on(torch, np, full, cpu))
            got, _, _ = card(_on(torch, np, full, dev))
            e_dev = _lm_err(np, got, want)
            cache = init_cache(cfg, 2, S + 1, device=dev)
            _, cache = prefill_fn(with_cache=True)(card, cache,
                                                    _on(torch, np, pre, dev))
            step, _ = decode_fn()(card, cache, _on(torch, np, dec[0], dev))
            e_dec = _lm_err(np, step, got[:, -1])
        torch.cuda.synchronize()
        log(f"[lm] smoke {arch}: card vs CPU forward max rel err {e_dev:.3e}"
            f" (bound {RTOL_LM_DEVICE:g}); decode vs forward on the card "
            f"{e_dec:.3e} (bound {RTOL_LM_DECODE:g})")
        if not (e_dev <= RTOL_LM_DEVICE and e_dec < RTOL_LM_DECODE):
            fail(f"lm smoke {arch}: forward {e_dev:.3e}, decode {e_dec:.3e}")
        out[arch] = {"forward_err": e_dev, "decode_err": e_dec}

    cfg = replace(reduce_for_smoke(get_config("h2o-danube-1.8b")),
                  dtype="float32")
    host = LM(cfg, device=cpu, seed=0)
    card = copy.deepcopy(host).to(dev)
    toks = []
    for model, d in ((host, cpu), (card, dev)):
        eng = ServeEngine(model, max_batch=3, device=d)
        rng = np.random.default_rng(0)
        for _ in range(7):
            eng.submit(rng.integers(0, cfg.vocab, rng.integers(3, 9)),
                       max_new=5)
        eng.run()
        toks.append([eng.completed[r].tokens for r in range(7)])
    log(f"[lm] smoke ServeEngine h2o-danube: 7 requests, card tokens equal "
        f"to the CPU's: {toks[0] == toks[1]}")
    if toks[0] != toks[1]:
        fail(f"lm smoke ServeEngine: card {toks[1]} != CPU {toks[0]}")
    out["engine_tokens_equal"] = True
    return out


def lm_decode_profile(torch, np, model, steps: int = 4,
                      batch: int = LM_BATCH, prompt: int = LM_PROMPT,
                      tag: str = "[lm]") -> dict:
    """``steps`` decode steps of a ``batch`` (by default the full-width
    batch, after a prefill of ``prompt`` tokens) under ``torch.profiler``:
    wall per step, the device's busy share of it, kernels per step and the
    costliest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import decode_fn, init_cache, prefill_fn

    cfg, dev = model.cfg, model.device
    inputs = _on(torch, np, launch_serve.prompts(cfg, batch, prompt), dev)
    with torch.inference_mode():
        cache = init_cache(cfg, batch, prompt + steps, device=dev,
                           dtype=model.dtype)
        logits, cache = prefill_fn(with_cache=True)(model, cache, inputs)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                step = {"token": nxt[:, None], "pos": torch.full(
                    (batch,), prompt + i, dtype=torch.int32, device=dev)}
                if cfg.mrope_sections:
                    step["positions"] = torch.full(
                        (3, batch, 1), prompt + i, dtype=torch.int32,
                        device=dev)
                logits, cache = decode_fn()(model, cache, step)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kern = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda ev: -ev.self_device_time_total)
    dev_ms = sum(ev.self_device_time_total for ev in kern) / 1e3
    n_kern = sum(ev.count for ev in kern)
    top = [{"name": ev.key[:70], "calls": ev.count,
            "ms": ev.self_device_time_total / 1e3} for ev in kern[:6]]
    log(f"{tag} decode profile ({steps} steps, batch {batch}, context "
        f"{prompt}): wall {wall / steps * 1e3:.2f} ms/step under the "
        f"profiler, device {dev_ms / steps:.3f} ms/step (busy "
        f"{dev_ms / (wall * 1e3):.1%}), {n_kern / steps:.0f} kernels/step")
    for t in top:
        log(f"{tag}   {t['ms'] / steps:.3f} ms/step x{t['calls'] // steps}"
            f"  {t['name']}")
    return {"wall_ms_per_step": wall / steps * 1e3,
            "device_ms_per_step": dev_ms / steps,
            "busy": dev_ms / (wall * 1e3), "kernels_per_step": n_kern / steps,
            "top": top}


def lm_consistency(torch, np, model, tag: str, bound: float) -> dict:
    """Batch 1, a 6,144-token prompt: prefill, then decode token 6,144,
    held against ``forward`` over 6,145 tokens at the last position."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import decode_fn, init_cache, prefill_fn

    cfg, dev = model.cfg, model.device
    T = LM_PROMPT + 1
    toks = _on(torch, np, launch_serve.prompts(cfg, 1, T, seed=1), dev)
    toks = toks["tokens"]
    with torch.inference_mode():
        want, _, _ = model({"tokens": toks}, last_only=True)
        cache = init_cache(cfg, 1, T, device=dev, dtype=model.dtype)
        _, cache = prefill_fn(with_cache=True)(
            model, cache, {"tokens": toks[:, :LM_PROMPT]})
        got, cache = decode_fn()(model, cache, {
            "token": toks[:, LM_PROMPT:], "pos": torch.full(
                (1,), LM_PROMPT, dtype=torch.int32, device=dev)})
        wrapped = [int(c["pos"].max()) for c in cache if "pos" in c]
        e = _lm_err(np, got, want[:, -1])
    slot = LM_PROMPT % cfg.window
    log(f"[lm] decode consistency {tag}: token {LM_PROMPT} (local ring "
        f"slot {slot} of {cfg.window}; newest ring position "
        f"{max(wrapped)}) against forward over {T}: max rel err {e:.3e} "
        f"(bound {bound:g})")
    if not (e < bound and wrapped and min(wrapped) == LM_PROMPT):
        fail(f"lm decode consistency {tag}: {e:.3e}, ring {wrapped}")
    return {"err": e, "bound": bound, "ring_slot": slot}


def lm_engine(torch, np, model) -> dict:
    """``ServeEngine`` at full width: 8 requests with heavy-tailed prompt
    lengths in [256, 4096] and ``max_new`` in [16, 64], ``max_batch=4``
    (two gangs); each request gets its ``max_new`` tokens."""
    from repro_torch.serve import ServeEngine

    rng = np.random.default_rng(18)
    lens = np.clip((256 * (1.0 + rng.pareto(1.2, 8))).astype(int), 256, 4096)
    max_new = rng.integers(16, 65, 8)
    eng = ServeEngine(model, max_batch=4, device=model.device)
    for n, m in zip(lens, max_new):
        eng.submit(rng.integers(0, model.cfg.vocab, int(n)), max_new=int(m))
    stats = eng.run()
    got = [len(eng.completed[r].tokens) for r in range(8)]
    log(f"[lm] ServeEngine {model.cfg.name} bf16: prompt lengths "
        f"{lens.tolist()}, max_new {max_new.tolist()}; requests "
        f"{stats['requests']}, tokens {stats['tokens']}, "
        f"{stats['tok_per_s']:.1f} tok/s, wall {stats['wall_s']:.3f} s, "
        f"mean TTFT {stats['mean_ttft_s'] * 1e3:.1f} ms")
    if got != max_new.tolist() or stats["requests"] != 8:
        fail(f"lm ServeEngine: tokens per request {got} != {max_new}")
    return {"prompt_lens": lens.tolist(), "max_new": max_new.tolist(),
            **stats}


def lm_batched_vs_sequential(torch, np, model) -> dict:
    """f32: two equal-length prompts prefilled as one batch give the
    first-token logits of two single-prompt prefills; then the engine's
    tokens for both, batched and sequential (printed, not held: random
    weights over 256,000 logits can flip an argmax on a near tie)."""
    from repro_torch.models import init_cache, prefill_fn
    from repro_torch.serve import ServeEngine

    cfg, dev = model.cfg, model.device
    rng = np.random.default_rng(19)
    prompts = rng.integers(0, cfg.vocab, (2, 1024)).astype(np.int32)
    with torch.inference_mode():
        def first_logits(p):
            cache = init_cache(cfg, len(p), len(p[0]) + 1, device=dev,
                               dtype=model.dtype)
            lg, _ = prefill_fn(with_cache=True)(
                model, cache, {"tokens": torch.from_numpy(p).to(dev)})
            return lg
        batched = first_logits(prompts)
        seq = torch.cat([first_logits(prompts[i:i + 1]) for i in range(2)])
        e = _lm_err(np, batched, seq)
    toks = []
    for mb in (2, 1):
        eng = ServeEngine(model, max_batch=mb, device=dev)
        for p in prompts:
            eng.submit(p, max_new=8)
        eng.run()
        toks.append([eng.completed[r].tokens for r in range(2)])
    log(f"[lm] batched vs sequential f32: first-token logits max rel err "
        f"{e:.3e} (bound {RTOL_LM_DECODE:g}); tokens batched {toks[0]}, "
        f"sequential {toks[1]}")
    if not e < RTOL_LM_DECODE:
        fail(f"lm batched vs sequential: {e:.3e}")
    return {"err": e, "tokens_equal": toks[0] == toks[1]}


def phase_lm(torch, np) -> dict:
    """The LM substrate on the card (no TPU kernel; plain torch ops):
    ten smoke architectures against the CPU; gemma2-2b at full width
    through ``launch.serve``'s path in bf16; decode consistency at 6,144
    tokens in f32 and bf16; ``ServeEngine`` with 8 requests in two gangs;
    batched against sequential first-token logits in f32.  The phase sets
    ``allow_bf16_reduced_precision_reduction = False`` (bf16 matmuls
    reduce in f32, as the reference's products accumulate); TF32 is off
    for the whole script."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(DEVICE)
    fns = _kernel_fns()
    _reset(*fns.values())
    out = {"smoke": lm_smoke(torch, np, dev)}

    cfg = get_config(LM_ARCH)
    model = LM(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    launch_serve.generate(model, launch_serve.prompts(cfg, LM_BATCH, 64), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = launch_serve.generate(
        model, launch_serve.prompts(cfg, LM_BATCH, LM_PROMPT), LM_GEN)
    peak = torch.cuda.max_memory_allocated()
    dec_ms = sorted(s * 1e3 for s in res["decode_s"])
    p50 = statistics.median(dec_ms)
    log(f"[lm] {cfg.name} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}) bf16: {n_params:,} parameters, "
        f"{w_bytes / 1e9:.3f} GB of weights; batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, gen {LM_GEN}: prefill {res['prefill_s'] * 1e3:.1f} "
        f"ms, decode p50 {p50:.2f} ms/step (min {dec_ms[0]:.2f}, max "
        f"{dec_ms[-1]:.2f}; weight-read bound {w_bytes / PEAK_BYTES_S * 1e3:.3f}"
        f" ms), {res['tok_per_s']:.1f} tok/s over {res['wall_s']:.3f} s; "
        f"peak memory {peak / 1e9:.3f} GB; logits finite {res['finite']}")
    if not res["finite"] or res["tokens"].shape != (LM_BATCH, LM_GEN):
        fail(f"lm full width: finite={res['finite']}, tokens "
             f"{res['tokens'].shape}")
    out["full"] = {"arch": cfg.name, "params": n_params,
                   "weight_bytes": w_bytes, "peak_bytes": peak,
                   "prefill_ms": res["prefill_s"] * 1e3,
                   "decode_ms_p50": p50, "tok_per_s": res["tok_per_s"],
                   "wall_s": res["wall_s"]}
    out["decode_profile"] = lm_decode_profile(torch, np, model)
    out["consistency_bf16"] = lm_consistency(torch, np, model, "bf16",
                                             RTOL_LM_BF16)
    out["engine"] = lm_engine(torch, np, model)

    model32 = LM(cfg, device="meta", dtype="float32").to_empty(device=dev)
    with torch.no_grad():
        for p32, p16 in zip(model32.parameters(), model.parameters()):
            p32.copy_(p16)
    del model
    torch.cuda.empty_cache()
    out["consistency_f32"] = lm_consistency(torch, np, model32, "f32",
                                            RTOL_LM_DECODE)
    out["batched_f32"] = lm_batched_vs_sequential(torch, np, model32)
    del model32
    torch.cuda.empty_cache()
    out["launches"] = _launches()
    log(f"[lm] kernel launches over the phase (none on this path): "
        f"{out['launches']}")
    return out


# --------------------------------------------------------------------------
# serving at the published widths: the other architectures through launch.serve
# --------------------------------------------------------------------------

# smallest first, so that a fault shows before the long runs
WIDTH_ARCHS = ("whisper-tiny", "h2o-danube-1.8b", "gemma3-4b", "zamba2-7b",
               "olmoe-1b-7b", "rwkv6-7b", "qwen2-vl-7b", "starcoder2-15b")
WIDTH_LEFT_OUT = "llama4-maverick-400b-a17b"    # its weights outgrow a card
WIDTH_BATCH, WIDTH_PROMPT, WIDTH_GEN = 2, 2_048, 16
# 2,048 = 16 of Mamba2's 128-token chunks and 32 of RWKV-6's 64-token ones
WIDTH_DEPTH = 4         # the f32 check's depth: the fewest whole layer
                        # cycles that hold at least 4 layers
RTOL_WIDTH = {"zamba2-7b": 1.2e-2}  # the f32 check's bound where it is not
# RTOL_LM_DECODE: zamba2's random Mamba2 stack amplifies float32 rounding
# at its width.  Decode against forward 5.794e-3 on an H100 80GB HBM3 at
# 700 W, where the same forward moves 5.525e-3 when its first row runs
# alone (other GEMM shapes); about twice the measured error.


def width_arch(torch, np, arch: str, dev) -> dict:
    """One architecture at its published configuration through
    ``launch.serve``: bf16, seed 0, a warm-up ``generate`` (the full
    prompts, 2 tokens), then ``generate`` of ``WIDTH_GEN`` tokens for
    ``WIDTH_BATCH`` prompts of ``WIDTH_PROMPT`` tokens (whisper's frames
    as long as its prompt), timed; one decode step under the profiler; then
    the float32 check at full width and cut depth (MoE dropless): each
    logit ``generate`` chose a token from, against the teacher-forced
    forward over the prompt and the fed-back tokens (``RTOL_LM_DECODE``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import LM

    cfg = get_config(arch)
    model = LM(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    inputs = launch_serve.prompts(cfg, WIDTH_BATCH, WIDTH_PROMPT)
    launch_serve.generate(model, inputs, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = launch_serve.generate(model, inputs, WIDTH_GEN)
    peak = torch.cuda.max_memory_allocated()
    dec_ms = sorted(t * 1e3 for t in res["decode_s"])
    p50 = statistics.median(dec_ms)
    log(f"[width] {arch} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}) bf16: {n_params:,} parameters, "
        f"{w_bytes / 1e9:.3f} GB of weights; batch {WIDTH_BATCH}, prompt "
        f"{WIDTH_PROMPT}, gen {WIDTH_GEN}: prefill "
        f"{res['prefill_s'] * 1e3:.1f} ms, decode p50 {p50:.2f} ms/step "
        f"(min {dec_ms[0]:.2f}, max {dec_ms[-1]:.2f}; weight-read bound "
        f"{w_bytes / PEAK_BYTES_S * 1e3:.3f} ms), {res['tok_per_s']:.1f} "
        f"tok/s over {res['wall_s']:.3f} s; peak memory {peak / 1e9:.3f} "
        f"GB; logits finite {res['finite']}")
    if not res["finite"] or res["tokens"].shape != (WIDTH_BATCH, WIDTH_GEN):
        fail(f"width {arch}: finite={res['finite']}, tokens "
             f"{res['tokens'].shape}")
    out = {"params": n_params, "weight_bytes": w_bytes, "peak_bytes": peak,
           "prefill_ms": res["prefill_s"] * 1e3, "decode_ms_p50": p50,
           "decode_ms_min": dec_ms[0], "decode_ms_max": dec_ms[-1],
           "tok_per_s": res["tok_per_s"], "wall_s": res["wall_s"],
           "finite": res["finite"],
           "profile": lm_decode_profile(torch, np, model, steps=1,
                                        batch=WIDTH_BATCH,
                                        prompt=WIDTH_PROMPT,
                                        tag=f"[width] {arch}")}
    del model
    torch.cuda.empty_cache()

    cut = launch_serve.dropless(launch_serve.cut_depth(cfg, WIDTH_DEPTH))
    model = LM(cut, device=dev, dtype="float32", seed=0)
    res = launch_serve.generate(model, inputs, WIDTH_GEN, keep_logits=True)
    want = launch_serve.teacher_forced(model, inputs, res["tokens"])
    e = _lm_err(np, res["logits"], want)
    # the same forward, its first row alone: how far float32 rounding in
    # another order (other GEMM shapes) moves these logits
    alone = launch_serve.teacher_forced(
        model, {k: v[:1] for k, v in inputs.items()}, res["tokens"][:1])
    e_order = _lm_err(np, alone, want[:1])
    bound = RTOL_WIDTH.get(arch, RTOL_LM_DECODE)
    log(f"[width] {arch} f32 at {cut.n_layers} of {cfg.n_layers} layers, "
        f"full width, capacity factor {cut.capacity_factor:g}: "
        f"{WIDTH_GEN} decoded positions x {WIDTH_BATCH} against "
        f"the teacher-forced forward over {WIDTH_PROMPT + WIDTH_GEN - 1} "
        f"tokens (padded to a multiple of "
        f"{launch_serve.seq_multiple(cfg)}): max rel err {e:.3e} (bound "
        f"{bound:g}); the forward of row 0 alone against the batch's "
        f"{e_order:.3e}")
    if not (e < bound and res["finite"]):
        fail(f"width {arch}: f32 decode against forward {e:.3e}")
    out["f32_check"] = {"layers": cut.n_layers, "err": e, "bound": bound,
                        "row_alone_err": e_order}
    del model, res, want, alone
    torch.cuda.empty_cache()
    return out


def phase_width(torch, np) -> dict:
    """The serving path of every architecture that fits one card, at its
    published width (``WIDTH_ARCHS``, smallest first; no TPU kernel: plain
    torch ops), each through :func:`width_arch`, its memory freed before
    the next; llama4-maverick is left out (its bf16 weights, counted on
    the meta device, do not fit) and stays traced only.  Sets
    ``allow_bf16_reduced_precision_reduction = False`` as the ``lm``
    phase does."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(DEVICE)
    fns = _kernel_fns()
    _reset(*fns.values())
    big = LM(get_config(WIDTH_LEFT_OUT), device="meta")
    left = sum(p.numel() * p.element_size() for p in big.parameters())
    del big
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"[width] {WIDTH_LEFT_OUT} left out: {left / 1e9:.1f} GB of bf16 "
        f"weights against the card's {card / 1e9:.1f} GB (traced only)")
    out = {"left_out": {"arch": WIDTH_LEFT_OUT, "weight_bytes": left}}
    for arch in WIDTH_ARCHS:
        t0 = time.perf_counter()
        out[arch] = width_arch(torch, np, arch, dev)
        out[arch]["arch_wall_s"] = time.perf_counter() - t0
        log(f"[width] {arch}: {out[arch]['arch_wall_s']:.1f} s")
    out["launches"] = _launches()
    log(f"[width] kernel launches over the phase (none on this path): "
        f"{out['launches']}")
    return out


# --------------------------------------------------------------------------
# LM training: models.lm's loss and train step, train/, distributed/checkpoint
# --------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 2, 5_120
# 5,120 = 10 CE and attention chunks of 512, > window + 512 (4,608): the
# banded local attention runs in the forward, its recompute and backward
TRAIN_STEPS = 5         # timed steps at full width, after one warm-up
TRAIN_LR = 1e-3
RTOL_TRAIN_LOSS = 1e-5  # f32 smoke loss, card against the CPU
RTOL_TRAIN_GRAD = 1e-4  # f32 smoke gradients and updated parameters, card
                        # against the CPU, of the leaf's max abs
RTOL_TRAIN_GRAD_ZAMBA2 = 5e-4   # zamba2's gradients: its random Mamba2
                        # stack is ill-conditioned (the reference's own
                        # A_log gradient moves 1.46e-4 under a 1e-7 weight
                        # perturbation; tests/test_torch_train.py's bound)
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores (data sheet)
PEAK_F32_FLOPS = 67e12    # H100 SXM float32 outside the tensor cores


def _train_batch(np, cfg, key: int = 0) -> dict:
    """tests/test_models_smoke.py's ``_batch_for`` inputs, B 2, S 16."""
    B, S = 2, 16
    rng = np.random.default_rng(key)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)
                                          ).astype(np.float32)
    if cfg.frontend == "patches":
        b["patch_embeds"] = rng.standard_normal((B, 4, cfg.d_model)
                                                ).astype(np.float32)
        b["tokens"] = b["tokens"][:, :S - 4]
    if cfg.mrope_sections:
        b["positions"] = np.broadcast_to(np.arange(S), (3, B, S)
                                         ).astype(np.int32)
    return b


def _loss_grads(torch, model, batch):
    from repro_torch.models.lm import loss_fn

    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    return float(loss.detach()), dict(zip(names, grads))


def _leaf_errs(torch, got: dict, want: dict) -> dict:
    """max |got - want| over the leaf's max |want|, leaf by leaf, in
    float32 on ``got``'s device (each leaf of ``want`` moved there)."""
    out = {}
    for n, w in want.items():
        g = got[n].detach().float()
        w = w.detach().to(g.device).float()
        out[n] = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    return out


def train_smoke(torch, np, dev) -> dict:
    """All ten architectures at ``reduce_for_smoke`` size in f32, the same
    weights on the card and on the CPU: the loss and every gradient; then
    AdamW on the card fed the CPU's gradients against AdamW on the CPU
    (updated parameters); then ``train_step_fn`` on both (the loss held;
    the updated parameters' largest difference printed: where a gradient
    element is near 0 its sign, and so a step of ``lr``, may differ)."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
    from repro_torch.models import LM, train_step_fn
    from repro_torch.train import AdamW

    cpu = torch.device("cpu")
    out = {}
    for arch in ARCHS:
        cfg = replace(reduce_for_smoke(get_config(arch)), dtype="float32")
        host = LM(cfg, device=cpu, seed=0)
        card = copy.deepcopy(host).to(dev)
        batch = _train_batch(np, cfg)
        bh, bc = _on(torch, np, batch, cpu), _on(torch, np, batch, dev)
        lh, gh = _loss_grads(torch, host, bh)
        lc, gc = _loss_grads(torch, card, bc)
        e_loss = abs(lc - lh) / abs(lh)
        errs = _leaf_errs(torch, gc, gh)
        g_worst = max(errs, key=errs.get)

        opt = AdamW(lr=TRAIN_LR)
        ph, pc = dict(host.named_parameters()), dict(card.named_parameters())
        sh, sc = opt.init(ph), opt.init(pc)
        opt.update(ph, gh, sh)
        opt.update(pc, {n: g.to(dev) for n, g in gh.items()}, sc)
        uerrs = _leaf_errs(torch, pc, ph)
        u_worst = max(uerrs, key=uerrs.get)

        step = train_step_fn(opt)
        l2h = float(step(host, sh, bh))
        l2c = float(step(card, sc, bc))
        torch.cuda.synchronize()
        e_loss2 = abs(l2c - l2h) / abs(l2h)
        g_bound = (RTOL_TRAIN_GRAD_ZAMBA2 if arch == "zamba2-7b"
                   else RTOL_TRAIN_GRAD)
        serrs = _leaf_errs(torch, pc, ph)
        s_worst = max(serrs, key=serrs.get)
        log(f"[train] smoke {arch}: loss {lc:.6f} (card) {lh:.6f} (CPU) rel "
            f"{e_loss:.3e}; gradients worst {errs[g_worst]:.3e} "
            f"({g_worst}; bound {g_bound:g}); AdamW on the CPU's "
            f"gradients worst {uerrs[u_worst]:.3e}; train_step_fn loss rel "
            f"{e_loss2:.3e}, parameters worst {serrs[s_worst]:.3e} "
            f"({s_worst}; printed, not held)")
        if not (e_loss <= RTOL_TRAIN_LOSS and e_loss2 <= RTOL_TRAIN_LOSS
                and errs[g_worst] <= g_bound
                and uerrs[u_worst] <= RTOL_TRAIN_GRAD
                and int(sc["step"]) == 2):
            fail(f"train smoke {arch}: loss {e_loss:.3e}/{e_loss2:.3e}, "
                 f"grad {errs[g_worst]:.3e}, update {uerrs[u_worst]:.3e}")
        out[arch] = {"loss_err": e_loss, "grad_err": errs[g_worst],
                     "update_err": uerrs[u_worst], "step_loss_err": e_loss2,
                     "step_param_err": serrs[s_worst]}
    return out


def train_resume(torch, np, dev, arch: str = LM_ARCH) -> dict:
    """``run_training`` at ``arch``'s ``reduce_for_smoke`` size (bf16) on
    the card: 12 steps with a checkpoint every 4; then a run that crashes
    at step 9 and its restart, which resumes from step 8.  The final
    parameters and the overlapping losses must equal the uninterrupted
    run's bit for bit."""
    import shutil
    from dataclasses import replace

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.train.trainer import (InjectedFailure, TrainLoopConfig,
                                           run_training)

    cfg = reduce_for_smoke(get_config(arch))
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    loop = TrainLoopConfig(steps=12, batch=4, seq=32, lr=TRAIN_LR,
                           ckpt_dir=str(root / "plain"), ckpt_interval=4)
    t0 = time.perf_counter()
    ref, ref_losses, _ = run_training(cfg, loop, device=DEVICE)
    crash = replace(loop, ckpt_dir=str(root / "crash"), fail_at_step=9)
    try:
        run_training(cfg, crash, device=DEVICE)
        fail("train resume: the injected failure did not fire")
    except InjectedFailure:
        pass
    res, res_losses, resumed = run_training(
        cfg, replace(crash, fail_at_step=None), device=DEVICE)
    wall = time.perf_counter() - t0
    same = [torch.equal(a, b) for a, b in zip(ref.parameters(),
                                               res.parameters())]
    log(f"[train] crash/resume {cfg.name} smoke ({cfg.dtype}) on the card: "
        f"resumed from {resumed}; parameters bitwise {sum(same)}/"
        f"{len(same)}; losses 8-11 bitwise {ref_losses[8:] == res_losses} "
        f"({res_losses}); three runs {wall:.1f} s")
    if resumed != 8 or not all(same) or ref_losses[8:] != res_losses:
        fail(f"train crash/resume {arch}: resumed {resumed}, parameters "
             f"{sum(same)}/{len(same)}, losses {ref_losses[8:]} vs "
             f"{res_losses}")
    shutil.rmtree(root, ignore_errors=True)
    return {"resumed_from": resumed, "params_bitwise": sum(same),
            "params": len(same), "losses": res_losses}


def train_flops(cfg, B: int, S: int) -> dict:
    """Operations of one train step of the port at full width, counted
    from the shapes: bf16 products (the layers' linear maps: forward, the
    group recompute and a backward of twice the forward; the LM head:
    forward, its chunk recompute and backward) and float32 products
    (attention's QK and PV on upcast operands, over the [chunk, T] slabs
    the port computes: T for global layers, window + 512 for local ones;
    the same four passes)."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    n_tok = B * S
    layer = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
             + (3 if cfg.mlp_gated else 2) * d * ff)
    lin = 2 * n_tok * layer * cfg.n_layers * 4
    head = 2 * n_tok * d * cfg.vocab * 4
    band = min(S, cfg.window + 512)
    attn = 0
    for kind in cfg.layer_kinds():
        T = band if kind.startswith("local") and S > band else S
        attn += 2 * 2 * B * cfg.n_heads * S * T * hd * 4
    return {"bf16": lin + head, "f32": attn}


def train_profile(torch, fn, tag: str = "[train]") -> dict:
    """One call of ``fn`` (a train step) under ``torch.profiler``, the
    card's activity only: wall, device time and busy share, kernels
    launched, the share of device time in matrix products (kernel names
    with gemm, xmma or nvjet) and the costliest kernels, logged under
    ``tag``.  The device events are summed from the profiler's raw
    records (``kineto_results``), not through ``key_averages()``, which
    first builds a Python event tree over every record of the step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        n, ms = by_name.get(ev.name(), (0, 0.0))
        by_name[ev.name()] = (n + 1, ms + ev.duration_ns() / 1e6)
    dev_ms = sum(ms for _, ms in by_name.values())
    mm_ms = sum(ms for k, (_, ms) in by_name.items()
                if any(w in k.lower() for w in ("gemm", "xmma", "nvjet")))
    top = [{"name": k[:70], "calls": n, "ms": ms} for k, (n, ms) in
           sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]]
    n_kern = sum(n for n, _ in by_name.values())
    log(f"{tag} profiled step: wall {wall * 1e3:.1f} ms under the "
        f"profiler, device {dev_ms:.1f} ms (busy {dev_ms / (wall * 1e3):.1%}"
        f"), {n_kern} kernels; matrix products {mm_ms:.1f} ms "
        f"({mm_ms / max(dev_ms, 1e-9):.1%} of device time)")
    for t in top:
        log(f"{tag}   {t['ms']:.1f} ms x{t['calls']}  {t['name']}")
    return {"wall_ms": wall * 1e3, "device_ms": dev_ms,
            "busy": dev_ms / (wall * 1e3), "kernels": n_kern,
            "matmul_ms": mm_ms, "top": top}


class GradNorm:
    """AdamW's ``grad_transform`` hook: keeps each step's global gradient
    norm (a device scalar, read after the steps) and passes the gradients
    on unchanged."""

    def __init__(self):
        self.norms = []

    def apply(self, grads, state):
        import torch

        sq = torch.stack([g.float().square().sum()
                          for g in grads.values()]).sum()
        self.norms.append(sq.sqrt())
        return grads, state


def train_full(torch, np, dev) -> dict:
    """gemma2-2b at full width and depth in bf16 with float32 AdamW
    moments, lr 1e-3, ``SyntheticLM`` seed 0, batch 2 x 5,120: one warm-up
    step, then ``TRAIN_STEPS`` steps each timed on the host clock with the
    device synced, then one step under the profiler.  The global gradient
    norm comes from AdamW's ``grad_transform`` hook; the losses, the norms
    and every parameter after the last step must be finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM, train_step_fn
    from repro_torch.train import AdamW
    from repro_torch.train.data import SyntheticLM

    hook = GradNorm()
    cfg = get_config(LM_ARCH)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device=dev, seed=0)
    opt = AdamW(lr=TRAIN_LR, grad_transform=hook)
    state = opt.init(dict(model.named_parameters()))
    step = train_step_fn(opt)
    src = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    states = torch.cuda.memory_allocated() - base
    losses, times = [], []
    for i in range(TRAIN_STEPS + 1):
        batch = _on(torch, np, src.batch_for_step(i), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() - base
    batch = _on(torch, np, src.batch_for_step(TRAIN_STEPS + 1), dev)
    prof = train_profile(torch, lambda: losses.append(
        float(step(model, state, batch))))
    norms = [float(n) for n in hook.norms]
    finite = (all(math.isfinite(v) for v in losses + norms) and
              all(bool(torch.isfinite(p).all()) for p in model.parameters()))
    ms = sorted(t * 1e3 for t in times[1:])
    med = statistics.median(ms)
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bound = {"bf16": flops["bf16"] / PEAK_BF16_FLOPS * 1e3,
             "f32": flops["f32"] / PEAK_F32_FLOPS * 1e3}
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    log(f"[train] {cfg.name} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}) bf16, f32 AdamW moments: "
        f"{n_params:,} parameters; batch {TRAIN_BATCH} x {TRAIN_SEQ}; "
        f"warm-up step {times[0] * 1e3:.1f} ms; step p50 {med:.1f} ms (min "
        f"{ms[0]:.1f}, max {ms[-1]:.1f}) over {TRAIN_STEPS}; "
        f"{tok_s:.1f} tokens/s; weights and AdamW states "
        f"{states / 1e9:.3f} GB, peak {peak / 1e9:.3f} GB "
        f"(max_memory_allocated above the {base / 1e9:.3f} GB held before)")
    log(f"[train] losses {[round(v, 6) for v in losses]}; global grad norm "
        f"{[round(v, 6) for v in norms]}; all finite {finite}")
    total = bound["bf16"] + bound["f32"]
    log(f"[train] bound: {flops['bf16'] / 1e12:.1f} TFLOP bf16 at 989 "
        f"TFLOP/s = {bound['bf16']:.1f} ms, {flops['f32'] / 1e12:.1f} TFLOP "
        f"f32 at 67 TFLOP/s = {bound['f32']:.1f} ms; sum {total:.1f} ms "
        f"({total / med:.1%} of the step)")
    if not finite or len(norms) != TRAIN_STEPS + 2:
        fail(f"train full width: finite={finite}, losses {losses}, "
             f"norms {norms}")
    del model, state
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "params": n_params, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "warmup_ms": times[0] * 1e3, "step_ms": ms,
            "step_ms_p50": med, "tokens_per_s": tok_s,
            "state_bytes": states, "peak_bytes": peak, "losses": losses,
            "grad_norms": norms, "flops": flops, "bound_ms": bound,
            "profile": prof}


def phase_train(torch, np) -> dict:
    """The LM substrate's training path on the card (no TPU kernel; plain
    torch ops and autograd): ten smoke architectures against the CPU;
    crash and resume of ``run_training`` bitwise at gemma2-2b's smoke
    size; gemma2-2b at full width, batch 2 x 5,120.  Sets
    ``allow_bf16_reduced_precision_reduction = False`` as the ``lm`` phase
    does."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(DEVICE)
    fns = _kernel_fns()
    _reset(*fns.values())
    out = {"smoke": train_smoke(torch, np, dev),
           "resume": train_resume(torch, np, dev),
           "full": train_full(torch, np, dev)}
    out["launches"] = _launches()
    log(f"[train] kernel launches over the phase (none on this path): "
        f"{out['launches']}")
    return out


# --------------------------------------------------------------------------
# training at the published widths: the architectures that fit one card
# --------------------------------------------------------------------------

TRAIN_WIDTH_SEQ = 4_096   # the train_4k cell's length: 32 Mamba2 chunks of
                          # 128, 64 RWKV-6 chunks of 64, 8 CE chunks of 512
TRAIN_WIDTH_BATCH = 2
TRAIN_WIDTH_BUDGET = 80e9       # the card's 80 GB (data sheet)
TRAIN_WIDTH_ROW = 14e9  # activations the plan assumes a 4,096-token row
# takes above the states with per-group remat: about twice gemma2-2b's 7.5
# GB a 5,120-token row (46.4 GB peak over 31.4 GB of states at 2 x 5,120
# in the train phase, on an H100 80GB HBM3 at 700 W), for the 7 B models'
# wider layers and longer chunk loops
TRAIN_WIDTH_CHECK = (1, 256)    # the f32 check's batch x seq, at the depth
                                # of launch.serve.cut_depth(cfg, WIDTH_DEPTH)
TRAIN_WIDTH_RESUME = ("olmoe-1b-7b", "zamba2-7b")  # crash/resume beside
                                                   # the train phase's
TRAIN_WIDTH_STEPS = 2   # timed steps, after the counted warm-up: zamba2's
                        # and rwkv6's chunk loops take 13-18 s a step on
                        # an H100 80GB HBM3 at 700 W
RTOL_TRAIN_WIDTH_GRAD = {"zamba2-7b": 1.2e-2}   # the f32 check's gradient
# bound where RTOL_TRAIN_GRAD does not hold: zamba2's random Mamba2 stack
# amplifies float32 rounding at its width.  Card against CPU 5.998e-03 on
# an H100 80GB HBM3 at 700 W, where the card's own gradients of the row
# twice against once move 2.903e-03 (other GEMM shapes); about twice the
# measured error, as RTOL_WIDTH holds its decode
PEAK_RATES = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_F32_FLOPS}


def train_width_plan(torch) -> dict:
    """Memory plan of every architecture but ``LM_ARCH`` (the train phase
    trains it) at its published configuration, reckoned on the ``meta``
    device before anything is built: parameters, plus one gradient a
    parameter in the parameter's type, plus AdamW's two moments (float32:
    8 B a parameter; bfloat16: 4 B).  The first of f32 moments at batch 2,
    f32 at batch 1, bf16 at batch 2, bf16 at batch 1 whose states plus
    ``TRAIN_WIDTH_ROW`` a row fit ``TRAIN_WIDTH_BUDGET`` is the plan; a cut
    batch is listed in ``reduced``; an architecture none fits is left out
    with its bytes.  Entries in ``WIDTH_ARCHS`` order, smallest first."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    plan = {}
    for arch in WIDTH_ARCHS + (WIDTH_LEFT_OUT,):
        model = LM(get_config(arch), device="meta")
        ps = list(model.parameters())
        n = sum(p.numel() for p in ps)
        w = sum(p.numel() * p.element_size() for p in ps)
        del model
        states = {m: 2 * w + n * 2 * size for m, size in
                  (("float32", 4), ("bfloat16", 2))}
        entry = {"params": n, "weight_bytes": w, "state_bytes": states}
        for moments in ("float32", "bfloat16"):
            for batch in range(TRAIN_WIDTH_BATCH, 0, -1):
                need = states[moments] + batch * TRAIN_WIDTH_ROW
                if need <= TRAIN_WIDTH_BUDGET:
                    break
            else:
                continue
            reduced = ([f"batch {TRAIN_WIDTH_BATCH} -> {batch}"]
                       if batch < TRAIN_WIDTH_BATCH else [])
            entry.update(moments=moments, batch=batch, seq=TRAIN_WIDTH_SEQ,
                         reduced=reduced, planned_bytes=need)
            break
        plan[arch] = entry
    return plan


def _width_batch(np, cfg, B: int, S: int, step: int = 0) -> dict:
    """One step's inputs at batch ``B`` and sequence ``S``, laid out as
    the train_4k cell lays them out (``configs.base.step_specs``):
    ``SyntheticLM``'s tokens and labels (seed 0, step ``step``); whisper's
    frames [B, S, d] (standard normal, as ``launch.serve.prompts`` makes
    them); qwen2-vl's ``min(1024, S // 4)`` patch embeddings ahead of its
    ``S - n_vis`` tokens and its M-RoPE positions [3, B, S], every stream
    0..S-1."""
    from repro_torch.train.data import SyntheticLM

    b = SyntheticLM(cfg.vocab, B, S, seed=0).batch_for_step(step)
    rng = np.random.default_rng(step)
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal((B, S, cfg.d_model)
                                          ).astype(np.float32)
    if cfg.frontend == "patches":
        n_vis = min(1024, S // 4)
        b["patch_embeds"] = rng.standard_normal((B, n_vis, cfg.d_model)
                                                ).astype(np.float32)
        b["tokens"] = b["tokens"][:, :S - n_vis]
    if cfg.mrope_sections:
        b["positions"] = np.broadcast_to(np.arange(S), (3, B, S)
                                         ).astype(np.int32)
    return b


def _rows_twice(np, batch: dict) -> dict:
    """``batch`` with every row repeated (positions' batch axis is 1)."""
    return {k: np.concatenate([v, v], axis=1 if k == "positions" else 0)
            for k, v in batch.items()}


def train_width_f32(torch, np, arch: str, dev) -> dict:
    """``arch`` at full width and ``launch.serve.cut_depth(cfg,
    WIDTH_DEPTH)`` in float32, one ``LM`` built on the CPU and a deep copy
    on the card, batch x seq ``TRAIN_WIDTH_CHECK``: the loss (rel
    ``RTOL_TRAIN_LOSS``) and every gradient (``RTOL_TRAIN_GRAD`` of each
    leaf's max abs; zamba2-7b ``RTOL_TRAIN_WIDTH_GRAD``) on the card
    against the CPU.  Printed beside them: the card's gradients of the
    same row twice against those of the row once (equal in exact
    arithmetic; other GEMM shapes), how far float32 rounding in another
    order moves them; and the seconds each part took."""
    import copy
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import LM

    t = [time.perf_counter()]
    cfg = replace(launch_serve.cut_depth(get_config(arch), WIDTH_DEPTH),
                  dtype="float32")
    cpu = torch.device("cpu")
    host = LM(cfg, device=cpu, seed=0)
    card = copy.deepcopy(host).to(dev)
    batch = _width_batch(np, cfg, *TRAIN_WIDTH_CHECK)
    t.append(time.perf_counter())
    lh, gh = _loss_grads(torch, host, _on(torch, np, batch, cpu))
    del host
    t.append(time.perf_counter())
    lc, gc = _loss_grads(torch, card, _on(torch, np, batch, dev))
    l2, g2 = _loss_grads(torch, card, _on(torch, np, _rows_twice(np, batch),
                                          dev))
    del card
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    e_loss = abs(lc - lh) / abs(lh)
    errs = _leaf_errs(torch, gc, gh)
    worst = max(errs, key=errs.get)
    order = _leaf_errs(torch, g2, gc)
    o_worst = max(order, key=order.get)
    t.append(time.perf_counter())
    bound = RTOL_TRAIN_WIDTH_GRAD.get(arch, RTOL_TRAIN_GRAD)
    secs = [round(b - a, 1) for a, b in zip(t, t[1:])]
    log(f"[train_width] {arch} f32 at {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, full width, batch x seq "
        f"{TRAIN_WIDTH_CHECK}: loss {lc:.6f} (card) {lh:.6f} (CPU) rel "
        f"{e_loss:.3e} (bound {RTOL_TRAIN_LOSS:g}); gradients worst "
        f"{errs[worst]:.3e} ({worst}; bound {bound:g}); the row twice on "
        f"the card against once: loss rel {abs(l2 - lc) / abs(lc):.3e}, "
        f"gradients worst {order[o_worst]:.3e} ({o_worst}); build, CPU, "
        f"card, compare {secs} s")
    out = {"layers": cfg.n_layers, "loss_err": e_loss,
           "grad_err": errs[worst], "grad_worst": worst, "bound": bound,
           "order_loss_err": abs(l2 - lc) / abs(lc),
           "order_grad_err": order[o_worst], "order_worst": o_worst,
           "seconds": secs}
    del gc, gh, g2
    torch.cuda.empty_cache()
    if not (e_loss <= RTOL_TRAIN_LOSS and errs[worst] <= bound):
        fail(f"train_width {arch} f32: loss {e_loss:.3e}, gradients "
             f"{errs[worst]:.3e} ({worst})")
    return out


def train_width_arch(torch, np, arch: str, entry: dict, dev) -> dict:
    """``arch`` at its published configuration, bf16, seed 0, AdamW (lr
    ``TRAIN_LR``) with the plan's moments, at the plan's batch x seq: a
    warm-up step under ``hlo_analysis.MatmulFlops`` (its matrix-product
    FLOPs by type give the bound at the data sheet's peaks),
    ``TRAIN_WIDTH_STEPS`` steps each timed on the host clock with the
    device synced, then one step under the profiler.  The losses, the
    global gradient norms and every parameter after the last step must be
    finite; an out-of-memory error is not caught."""
    from repro_torch.configs import get_config
    from repro_torch.launch.hlo_analysis import MatmulFlops
    from repro_torch.models import LM, train_step_fn
    from repro_torch.train import AdamW

    cfg = get_config(arch)
    B, S = entry["batch"], entry["seq"]
    hook = GradNorm()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device=dev, seed=0)
    opt = AdamW(lr=TRAIN_LR, grad_transform=hook,
                state_dtype=(entry["moments"] if entry["moments"] ==
                             "bfloat16" else None))
    state = opt.init(dict(model.named_parameters()))
    step = train_step_fn(opt)
    states = torch.cuda.memory_allocated() - base
    losses, times = [], []
    for i in range(TRAIN_WIDTH_STEPS + 1):
        batch = _on(torch, np, _width_batch(np, cfg, B, S, i), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with MatmulFlops() as counter:
                loss = step(model, state, batch)
        else:
            loss = step(model, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() - base
    batch = _on(torch, np,
                _width_batch(np, cfg, B, S, TRAIN_WIDTH_STEPS + 1), dev)
    prof = train_profile(torch, lambda: losses.append(
        float(step(model, state, batch))), tag=f"[train_width] {arch}")
    norms = [float(n) for n in hook.norms]
    finite = (all(math.isfinite(v) for v in losses + norms) and
              all(bool(torch.isfinite(p).all()) for p in model.parameters()))
    ms = sorted(t * 1e3 for t in times[1:])
    med = statistics.median(ms)
    flops = dict(counter.flops_by_dtype)
    if not set(flops) <= set(PEAK_RATES):
        fail(f"train_width {arch}: products of another type: {flops}")
    bound = sum(f / PEAK_RATES[dt] for dt, f in flops.items()) * 1e3
    tok_s = B * S / (med / 1e3)
    log(f"[train_width] {arch} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}) bf16, {entry['moments']} AdamW "
        f"moments: {entry['params']:,} parameters; batch {B} x {S} "
        f"(reduced {entry['reduced']}); warm-up step (under the FLOP "
        f"counter) {times[0] * 1e3:.1f} ms; step p50 {med:.1f} ms (min "
        f"{ms[0]:.1f}, max {ms[-1]:.1f}) over {TRAIN_WIDTH_STEPS}; "
        f"{tok_s:.1f} "
        f"tokens/s; weights and AdamW states {states / 1e9:.3f} GB, peak "
        f"{peak / 1e9:.3f} GB (max_memory_allocated above the "
        f"{base / 1e9:.3f} GB held before; planned "
        f"{entry['planned_bytes'] / 1e9:.1f} GB)")
    log(f"[train_width] {arch} losses {[round(v, 6) for v in losses]}; "
        f"global grad norm {[round(v, 6) for v in norms]}; all finite "
        f"{finite}")
    log(f"[train_width] {arch} bound: " + ", ".join(
        f"{f / 1e12:.2f} TFLOP {dt} at {PEAK_RATES[dt] / 1e12:.0f} TFLOP/s"
        for dt, f in sorted(flops.items())) + f" = {bound:.1f} ms "
        f"({bound / med:.1%} of the step p50)")
    if not finite or len(norms) != TRAIN_WIDTH_STEPS + 2:
        fail(f"train_width {arch}: finite={finite}, losses {losses}, "
             f"norms {norms}")
    del model, state, opt, hook, step
    torch.cuda.empty_cache()
    return {"params": entry["params"], "moments": entry["moments"],
            "batch": B, "seq": S, "reduced": entry["reduced"],
            "warmup_ms": times[0] * 1e3, "step_ms": ms, "step_ms_p50": med,
            "tokens_per_s": tok_s, "state_bytes": states, "peak_bytes": peak,
            "losses": losses, "grad_norms": norms, "flops": flops,
            "bound_ms": bound, "bound_share": bound / med, "profile": prof}


def phase_train_width(torch, np) -> dict:
    """The LM substrate's training path at the published widths (no TPU
    kernel; plain torch ops and autograd): the plan on ``meta``
    (:func:`train_width_plan`, printed, the left-out architectures with
    their bytes); then each planned architecture, smallest first, through
    :func:`train_width_f32` and :func:`train_width_arch`, its memory freed
    before the next; then ``run_training``'s crash and resume bitwise at
    ``TRAIN_WIDTH_RESUME``'s smoke sizes.  Sets
    ``allow_bf16_reduced_precision_reduction = False`` as the ``lm`` phase
    does, and ``allow_tf32 = False`` as ``main`` does (the f32 check's
    products in full float32)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    fns = _kernel_fns()
    _reset(*fns.values())
    torch.cuda.empty_cache()
    plan = train_width_plan(torch)
    for arch, e in plan.items():
        st = ", ".join(f"{m} moments {b / 1e9:.1f} GB"
                       for m, b in e["state_bytes"].items())
        if "moments" in e:
            log(f"[train_width] plan {arch}: {e['params']:,} parameters, "
                f"{st}: {e['moments']} moments, batch {e['batch']} x "
                f"{e['seq']}, reduced {e['reduced']}, "
                f"{e['planned_bytes'] / 1e9:.1f} GB with "
                f"{TRAIN_WIDTH_ROW / 1e9:g} GB of activations a row "
                f"(budget {TRAIN_WIDTH_BUDGET / 1e9:g} GB)")
        else:
            log(f"[train_width] plan {arch} left out: {e['params']:,} "
                f"parameters, {e['weight_bytes'] / 1e9:.1f} GB of bf16 "
                f"weights, {st}: no moments fit "
                f"{TRAIN_WIDTH_BUDGET / 1e9:g} GB with one row's "
                f"{TRAIN_WIDTH_ROW / 1e9:g} GB")
    out = {"plan": plan}
    for arch, e in plan.items():
        if "moments" not in e:
            continue
        t0 = time.perf_counter()
        check = train_width_f32(torch, np, arch, dev)
        res = dict(train_width_arch(torch, np, arch, e, dev), f32_check=check)
        res["arch_wall_s"] = time.perf_counter() - t0
        out[arch] = res
        log(f"[train_width] {arch}: {res['arch_wall_s']:.1f} s")
    out["resume"] = {a: train_resume(torch, np, dev, a)
                     for a in TRAIN_WIDTH_RESUME}
    out["launches"] = _launches()
    log(f"[train_width] kernel launches over the phase (none on this "
        f"path): {out['launches']}")
    return out


# --------------------------------------------------------------------------
# the distributed substrate: compression, pipeline, mesh rules, resharding
# --------------------------------------------------------------------------

DIST_PODS = 2           # gemma2-2b's compressed step: 2 pods of 1 x 5,120
DIST_STEPS = 3          # timed compressed steps, after the checked one
DIST_PARAM_BOUND = 5e-3  # compressed against plain parameters after step 1
                        # (the reference's test_dp_compressed_train_step)
DIST_CHECK = ("embed", "layers.0.attn.wq", "layers.0.ln1")
DIST_RANKS = 4          # gloo ranks sharing cuda:0 (NCCL refuses two ranks
                        # on one device)
PIPE_L, PIPE_B, PIPE_D, PIPE_MICRO = 8, 64, 2_304, 4   # D: gemma2's width
PIPE_BOUND = 1e-5       # pipelined against sequential, f32, TF32 off


def _same_bits(np, a, b) -> bool:
    """Bit for bit: two tensors or arrays of one type and shape."""
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    b = b.detach().cpu().numpy() if hasattr(b, "detach") else np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def _host_copy(t):
    return t.detach().to("cpu", copy=True)


def _local_shape(shape, spec, sizes) -> tuple:
    """The shard shape a spec gives each rank (dims divisible)."""
    return tuple(
        d // math.prod(sizes[a] for a in (
            () if e is None else (e,) if isinstance(e, str) else e))
        for d, e in zip(shape, spec))


def _dist_rank(rank, n, root):
    """One of the ``dist`` phase's gloo ranks on cuda:0: the compressed
    psum, the pipeline, the mesh rules with ``distribute_tensor``, the
    elastic restore and this rank's slice of a pane bucket through the
    masked kernel.  Returns numpy arrays and numbers only."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import comm, pipeline, sharding
    from repro_torch.distributed.checkpoint import (restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.distributed.compression import compressed_psum_tree
    from repro_torch.kernels import ops

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    case = torch.load(Path(root) / "case.pt")
    out = {}

    def timed(fn):
        comm.STAGING.reset()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        st = comm.STAGING
        return res, {"s": time.perf_counter() - t0, "copies": st.copies,
                     "bytes": st.bytes, "staging_s": st.seconds}

    g = {k: v.to(dev) for k, v in case["grads"][rank].items()}
    e = {k: v.to(dev) for k, v in case["errors"][rank].items()}
    (synced, new_e), out["psum_time"] = timed(
        lambda: compressed_psum_tree(g, e, None, n))
    out["psum"] = ({k: v.cpu().numpy() for k, v in synced.items()},
                   {k: v.cpu().numpy() for k, v in new_e.items()})

    gen = torch.Generator().manual_seed(0)
    Ws = (torch.randn(PIPE_L, PIPE_D, PIPE_D, generator=gen)
          * PIPE_D ** -0.5).to(dev)
    x = torch.randn(PIPE_B, PIPE_D, generator=gen).to(dev)

    def layer(W, h):
        return torch.tanh(h @ W)

    seq = pipeline.sequential_apply(layer, Ws, x)
    pipe, out["pipe_time"] = timed(lambda: pipeline.pipelined_apply(
        layer, Ws, x, n_micro=PIPE_MICRO))
    out["pipe_err"] = float((pipe - seq).abs().max())

    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    params = {k: v.to(dev) for k, v in case["params"].items()}
    specs = sharding.param_pspecs(params, mesh)
    placed = sharding.shardings_for(specs, mesh)
    sizes = sharding.mesh_axes(mesh)
    bad = []

    def check_params():
        for name, p in params.items():
            dt = distribute_tensor(p, *placed[name], src_data_rank=None)
            if (tuple(dt.to_local().shape) != _local_shape(
                    p.shape, specs[name], sizes)
                    or not torch.equal(comm.full_tensor(dt), p)):
                bad.append(name)

    _, out["sharding_time"] = timed(check_params)
    out["sharding"] = {"params": len(params), "bad": bad, "sharded": sum(
        any(e is not None for e in s) for s in specs.values())}

    mesh1 = init_device_mesh("cuda", (n,), mesh_dim_names=("data",))
    keep = [k for k, p in params.items() if p.shape[0] % n == 0]
    saved = {k: distribute_tensor(
        params[k], mesh1, sharding.placements_for(
            ("data",) + (None,) * (params[k].ndim - 1), mesh1),
        src_data_rank=None) for k in keep}
    ckpt = str(Path(root) / "ckpt")

    def elastic():
        save_checkpoint(ckpt, 1, saved)
        dist.barrier()
        return restore_checkpoint(ckpt, 1, {k: params[k] for k in keep},
                                  shardings={k: placed[k] for k in keep})

    got, out["elastic_time"] = timed(elastic)
    out["elastic"] = {"leaves": len(keep), "bad": [
        k for k in keep if not (
            tuple(got[k].to_local().shape)
            == _local_shape(params[k].shape, specs[k], sizes)
            and torch.equal(comm.full_tensor(got[k]).view(torch.uint8),
                            params[k].view(torch.uint8)))]}

    base, mask = case["base"].to(dev), case["mask"].to(dev)
    rows = sharding.shard_pane_bucket(
        torch.arange(base.shape[0], device=dev), mesh).to_local()
    db = sharding.shard_pane_bucket(base, mesh).to_local()
    dm = sharding.shard_pane_bucket(mask, mesh).to_local()
    before = ops.kernel_launches()
    res = ops.propagate_batched(db, dm, backend="cuda")
    torch.cuda.synchronize()
    after = ops.kernel_launches()
    out["launches"] = {k: after[k] - before[k] for k in after}
    out["bucket"] = (rows.cpu().numpy(), res.cpu().numpy())
    return out


def _bucket_shape(main_res) -> tuple:
    """The masked kernel's costliest f64 main-path shape with nb >= 4 (so
    that every data shard of the (2, 2) mesh holds bursts)."""
    for (nb, b, d, dt), *_ in main_res["shapes"]["hamlet_propagate"][
            "costliest"]:
        if dt == "float64" and nb >= 4:
            return nb, b, d
    return 78, 313, 2


def dist_ranks(torch, np, dev, main_res) -> dict:
    """Four gloo ranks on cuda:0, spawned on a ``file://`` store, each
    placing its tensors on cuda:0 (``_dist_rank``); held against the same
    work in this process."""
    import shutil

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.distributed import compression as C
    from repro_torch.distributed.ranks import spawn_ranks
    from repro_torch.kernels.hamlet_propagate import \
        masked_prefix_propagate_cuda
    from repro_torch.models import LM

    root = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = reduce_for_smoke(get_config(LM_ARCH))
    model = LM(cfg, device=dev, seed=0)
    grads = [{n: g.cpu() for n, g in _loss_grads(
        torch, model, _on(torch, np, _train_batch(np, cfg, key=r), dev)
    )[1].items()} for r in range(DIST_RANKS)]
    rng = np.random.default_rng(7)
    errors = [{n: torch.tensor(rng.standard_normal(tuple(g.shape)) * 1e-3,
                               dtype=torch.float32)
               for n, g in grads[0].items()} for _ in range(DIST_RANKS)]
    nb, b, d = _bucket_shape(main_res)
    base, mask = _masked_case(torch, np, rng, "cpu", nb, b, d, torch.float64,
                              "random")
    torch.save({"grads": grads, "errors": errors, "base": base, "mask": mask,
                "params": {n: p.detach().cpu()
                           for n, p in model.named_parameters()}},
               root / "case.pt")
    t0 = time.perf_counter()
    outs = spawn_ranks(_dist_rank, DIST_RANKS, store_dir=str(root),
                       backend="gloo", args=(str(root),), timeout=300)
    wall = time.perf_counter() - t0

    # the psum against the same sum in one process: the compressed step's
    # sync over the ranks' stacked gradients
    psum_bad = []
    for n in grads[0]:
        x = torch.stack([grads[r][n].to(dev).float() + errors[r][n].to(dev)
                         for r in range(DIST_RANKS)])
        synced, _, _ = C.sync_pods_(x, C.int8_scale(x), DIST_RANKS)
        for r, out in enumerate(outs):
            if not (_same_bits(np, out["psum"][0][n], synced)
                    and _same_bits(np, out["psum"][1][n], x[r])):
                psum_bad.append((r, n))
    t = outs[0]["psum_time"]
    log(f"[dist] ranks: {DIST_RANKS} gloo ranks on cuda:0 spawned and "
        f"joined in {wall:.1f} s; compressed_psum_tree on {cfg.name} smoke "
        f"gradients ({len(grads[0])} leaves, bf16, carried f32 errors): "
        f"synced and new errors of every rank bitwise equal to the stacked "
        f"sync in one process: {not psum_bad}; rank 0 {t['s'] * 1e3:.1f} ms "
        f"of which host staging {t['staging_s'] * 1e3:.1f} ms "
        f"({t['copies']} copies, {t['bytes']:,} bytes)")
    pipe_err = max(o["pipe_err"] for o in outs)
    t = outs[0]["pipe_time"]
    log(f"[dist] ranks: pipelined_apply L {PIPE_L}, B {PIPE_B}, D {PIPE_D}, "
        f"{DIST_RANKS} stages, n_micro {PIPE_MICRO}, f32 (TF32 off) against "
        f"sequential_apply: max |diff| {pipe_err:.3e} (bound {PIPE_BOUND:g});"
        f" rank 0 {t['s'] * 1e3:.1f} ms, host staging "
        f"{t['staging_s'] * 1e3:.1f} ms ({t['copies']} copies)")
    sh = outs[0]["sharding"]
    t = outs[0]["sharding_time"]
    log(f"[dist] ranks: param_pspecs on a (2, 2) data x model mesh, "
        f"distribute_tensor of {sh['params']} {cfg.name} smoke parameters "
        f"({sh['sharded']} sharded): local shapes as the rules say and "
        f"full_tensor() equal on every rank: "
        f"{not any(o['sharding']['bad'] for o in outs)} "
        f"({t['s'] * 1e3:.1f} ms, staging {t['staging_s'] * 1e3:.1f} ms)")
    el = outs[0]["elastic"]
    log(f"[dist] ranks: elastic restore of {el['leaves']} leaves saved from "
        f"a 1-D mesh of {DIST_RANKS}, restored onto the (2, 2) mesh by the "
        f"rules: bitwise on every rank "
        f"{not any(o['elastic']['bad'] for o in outs)} "
        f"({outs[0]['elastic_time']['s'] * 1e3:.1f} ms)")
    whole = masked_prefix_propagate_cuda(base.to(dev), mask.to(dev)).cpu()
    bucket_bad = [r for r, o in enumerate(outs) if not _same_bits(
        np, o["bucket"][1], whole[torch.as_tensor(o["bucket"][0])])]
    launches = {k: sum(o["launches"][k] for o in outs)
                for k in outs[0]["launches"]}
    spans = [(int(o["bucket"][0][0]), int(o["bucket"][0][-1])) for o in outs]
    log(f"[dist] ranks: shard_pane_bucket of a ({nb}, {b}, {d}) f64 masked "
        f"bucket (the main path's costliest such shape): rows {spans} "
        f"through ops.propagate_batched(backend='cuda') on each rank, "
        f"bitwise equal to those rows of one launch: {not bucket_bad}; the "
        f"ranks' kernel launches {launches}")
    if (psum_bad or pipe_err > PIPE_BOUND or bucket_bad
            or any(o["sharding"]["bad"] or o["elastic"]["bad"]
                   for o in outs)):
        fail(f"dist ranks: psum {psum_bad[:4]}, pipeline {pipe_err:.3e}, "
             f"sharding {[o['sharding']['bad'][:3] for o in outs]}, elastic "
             f"{[o['elastic']['bad'][:3] for o in outs]}, bucket "
             f"{bucket_bad}")
    shutil.rmtree(root, ignore_errors=True)
    del model
    return {"wall_s": wall, "launches": launches, "pipe_err": pipe_err,
            "bucket": [nb, b, d],
            "times": {k: outs[0][k] for k in ("psum_time", "pipe_time",
                                               "sharding_time",
                                               "elastic_time")}}


def dist_full(torch, np, dev) -> dict:
    """gemma2-2b at full width and depth in bf16 with float32 AdamW
    moments, lr 1e-3, ``SyntheticLM`` seed 0, batch 2 x 5,120 split over
    two pods: first ``train_step_fn`` from the start (its parameters kept
    on the host), then, from the same start, step 1 of
    ``dp_compressed_step_fn`` run as its three parts (the pods' gradients
    into the errors, the sync leaf by leaf, AdamW), each timed, its sync of
    ``DIST_CHECK``'s leaves held bit for bit against the same sync on the
    CPU from the same per-pod gradients, and its parameters against the
    plain step's; then ``DIST_STEPS`` steps through ``step`` timed on the
    host clock with the device synced."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import compression as C
    from repro_torch.models import LM, train_step_fn
    from repro_torch.train import AdamW
    from repro_torch.train.data import SyntheticLM

    def synced_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    cfg = get_config(LM_ARCH)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device=dev, seed=0)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(params)
    src = SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0)
    batch = _on(torch, np, src.batch_for_step(0), dev)

    start = {n: _host_copy(p) for n, p in params.items()}
    t0 = time.perf_counter()
    train_step_fn(opt)(model, state, batch)
    plain_ms = synced_ms(t0)
    plain = {n: _host_copy(p) for n, p in params.items()}
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(start[n])
        for key in ("m", "v"):
            for t in state[key].values():
                t.zero_()
        state["step"].zero_()
    del start
    step, init_errors = C.dp_compressed_step_fn(opt, DIST_PODS)
    errors = init_errors(model)
    states = torch.cuda.memory_allocated() - base

    def err_norm() -> float:
        return float(torch.stack([torch.linalg.vector_norm(e)
                                  for e in errors.values()]).norm())

    leaves = C.stacked_leaves(model)
    check = [leaf for leaf in leaves if set(leaf) & set(DIST_CHECK)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = C.accumulate_pod_grads_(model, errors, batch, DIST_PODS)
    grads_ms = synced_ms(t0)
    host_x = {n: _host_copy(errors[n]) for leaf in check for n in leaf}
    grads, card = {}, {}
    t0 = time.perf_counter()
    for leaf in leaves:
        s = C.int8_scale(*(errors[n] for n in leaf))
        for n in leaf:
            synced, q, summed = C.sync_pods_(errors[n], s, DIST_PODS)
            grads[n] = synced
            if n in DIST_CHECK:
                card[n] = (s, q, summed, synced)
    sync_ms = synced_ms(t0)
    t0 = time.perf_counter()
    opt.update(params, grads, state)
    adamw_ms = synced_ms(t0)
    del grads
    card = {n: tuple(_host_copy(t) for t in v + (errors[n],))
            for n, v in card.items()}
    losses = [float(losses.mean())]
    norms = [err_norm()]

    held = {}
    for leaf in check:
        s = C.int8_scale(*(host_x[n] for n in leaf))
        for n in leaf:
            if n not in DIST_CHECK:
                continue
            synced, q, summed = C.sync_pods_(host_x[n], s, DIST_PODS)
            want = (s, q, summed, synced, host_x[n])
            held[n] = {k: _same_bits(np, a, b) for k, a, b in zip(
                ("scale", "q", "int32 sum", "synced", "new errors"),
                card[n], want)}
    del host_x, card
    env = 0.0
    with torch.no_grad():
        for n, p in params.items():
            env = max(env, float((p.float() - plain[n].to(dev).float())
                                 .abs().max()))
    del plain

    times = []
    for i in range(1, DIST_STEPS + 1):
        b = _on(torch, np, src.batch_for_step(i), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, state, errors, b)
        times.append(synced_ms(t0))
        losses.append(float(loss))
        norms.append(err_norm())
    peak = torch.cuda.max_memory_allocated() - base
    finite = (all(math.isfinite(v) for v in losses + norms) and
              all(bool(torch.isfinite(p).all()) for p in params.values()))
    med = statistics.median(times)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (med / 1e3)
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    bound = (flops["bf16"] / PEAK_BF16_FLOPS + flops["f32"] / PEAK_F32_FLOPS
             ) * 1e3
    log(f"[dist] {cfg.name} full width ({n_params:,} parameters) bf16, f32 "
        f"AdamW moments, dp_compressed_step_fn with n_pods {DIST_PODS}: "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} ({DIST_PODS} pods of "
        f"{TRAIN_BATCH // DIST_PODS} x {TRAIN_SEQ}); weights, AdamW states "
        f"and errors {states / 1e9:.3f} GB")
    log(f"[dist] step 1 in parts: both pods' gradients into the errors "
        f"{grads_ms:.1f} ms, the sync ({len(leaves)} leaves) {sync_ms:.1f} "
        f"ms, AdamW {adamw_ms:.1f} ms; the plain train_step_fn from the "
        f"same start {plain_ms:.1f} ms")
    log(f"[dist] step p50 {med:.1f} ms (min {min(times):.1f}, max "
        f"{max(times):.1f}) over {DIST_STEPS}; {tok_s:.1f} tokens/s; peak "
        f"{peak / 1e9:.3f} GB (max_memory_allocated above the "
        f"{base / 1e9:.3f} GB held before); the step's FLOPs bound "
        f"{bound:.1f} ms ({bound / med:.1%} of the step)")
    log(f"[dist] losses {[round(v, 6) for v in losses]}; error norms "
        f"{[round(v, 6) for v in norms]}; all finite {finite}")
    for n, h in held.items():
        log(f"[dist] step 1's sync of {n}, card against the CPU from the "
            f"same per-pod gradients: {h}")
    log(f"[dist] parameters after step 1, compressed against plain: max "
        f"|diff| {env:.6g} (bound {DIST_PARAM_BOUND:g})")
    if (not finite or env > DIST_PARAM_BOUND
            or not all(all(h.values()) for h in held.values())
            or set(held) != set(DIST_CHECK)):
        fail(f"dist full width: finite={finite}, envelope {env}, sync "
             f"{held}")
    del model, state, errors, params
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "params": n_params, "n_pods": DIST_PODS,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "plain_ms": plain_ms,
            "parts_ms": {"grads": grads_ms, "sync": sync_ms,
                         "adamw": adamw_ms},
            "step_ms": times, "step_ms_p50": med, "tokens_per_s": tok_s,
            "state_bytes": states, "peak_bytes": peak, "losses": losses,
            "error_norms": norms, "sync_held": held, "envelope": env,
            "bound_ms": bound}


def phase_dist(torch, np, main_res) -> dict:
    """The distributed substrate on the card (``repro_torch.distributed``,
    ``launch.mesh``; torch ops and ``torch.distributed``, no TPU kernel
    but the masked kernel on the pane-bucket hook): four gloo ranks on
    cuda:0, then gemma2-2b's compressed data-parallel step at full width.
    Sets ``allow_bf16_reduced_precision_reduction = False`` as the ``lm``
    and ``train`` phases do."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    log(f"[dist] held on the card before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    fns = _kernel_fns()
    _reset(*fns.values())
    out = {"ranks": dist_ranks(torch, np, dev, main_res),
           "full": dist_full(torch, np, dev)}
    # the ranks' own launches (the comparison launch here does not count)
    out["launches"] = {name: out["ranks"]["launches"].get(name, 0)
                       for name in fns}
    log(f"[dist] kernel launches over the phase's path: {out['launches']}")
    if out["launches"]["hamlet_propagate"] == 0:
        fail("dist: the pane-bucket hook launched no masked kernel")
    return out


# --------------------------------------------------------------------------
# the lowering proofs: placeholder-world traces, and the pane step on the card
# --------------------------------------------------------------------------

LOWER_CELLS = ("prefill_32k", "train_4k")   # gemma2-2b on the (16, 16) mesh
# one cell of each architecture whose trace needs the per-shard einsum or
# MoE dispatch (the card's older DTensor refused them before), the cheap
# ones: olmoe's prefill shards its 16 KV heads 16 ways and runs the MoE
# dispatch per sequence; whisper's train step runs them backwards
LOWER_REPAIRED = (("olmoe-1b-7b", "prefill_32k"),
                  ("olmoe-1b-7b", "decode_32k"),
                  ("llama4-maverick-400b-a17b", "decode_32k"),
                  ("whisper-tiny", "train_4k"),
                  ("zamba2-7b", "decode_32k"),
                  ("rwkv6-7b", "decode_32k"))
PANE_DP = 16            # the card's pane step: the single pod's burst split
RTOL_PANE = 1e-4        # finite pane-step entries, twin against kernel,
                        # f32: |a - b| <= RTOL_PANE * (1 + |b|) (the blocked
                        # solve and the closed form round in another order
                        # than the kernels, over 256 rows)


def _pattern(np, a) -> dict:
    return {"finite": int(np.isfinite(a).sum()), "nan": int(np.isnan(a).sum()),
            "inf": int(np.isinf(a).sum())}


def _pane_held(np, what: str, twin, kernel, oracle) -> dict:
    """The twin against the kernel on every entry finite in both (the
    largest relative error and the bitwise entries), and the three
    non-finite patterns against each other."""
    t, k = (x.detach().to("cpu", copy=True).numpy() for x in (twin, kernel))
    both = np.isfinite(t) & np.isfinite(k)
    diff = np.abs(t[both] - k[both])
    rel = float((diff / (1.0 + np.abs(k[both]))).max()) if diff.size else 0.0
    out = {"entries": int(t.size), "both_finite": int(both.sum()),
           "bitwise": int((t[both] == k[both]).sum()), "max_rel_err": rel,
           "twin": _pattern(np, t), "kernel": _pattern(np, k),
           "np_oracle": _pattern(np, oracle),
           "kernel_vs_oracle_pattern_mismatch": int(
               (np.isnan(k) != np.isnan(oracle)).sum() +
               (np.isposinf(k) != np.isposinf(oracle)).sum() +
               (np.isneginf(k) != np.isneginf(oracle)).sum()),
           "twin_vs_oracle_pattern_mismatch": int(
               (np.isfinite(t) != np.isfinite(oracle)).sum() +
               (np.isnan(t) != np.isnan(oracle)).sum())}
    log(f"[lower] pane step, {what}: {out['both_finite']}/{out['entries']} "
        f"entries finite in twin and kernel, {out['bitwise']} bitwise, max "
        f"rel err {rel:.3e} (bound {RTOL_PANE}); non-finite: twin "
        f"{out['twin']}, kernel {out['kernel']}, np oracle "
        f"{out['np_oracle']}; kernel/oracle pattern mismatches "
        f"{out['kernel_vs_oracle_pattern_mismatch']}, twin/oracle "
        f"{out['twin_vs_oracle_pattern_mismatch']}")
    return out


def lower_traces(torch) -> dict:
    """The pane step's proof on both production meshes, gemma2-2b's
    ``LOWER_CELLS`` and the ``LOWER_REPAIRED`` cells on the single pod's,
    each mesh in its own placeholder world; every record printed, any
    status but ``ok`` fails."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, \
        placeholder_world

    recs = []
    for multi in (False, True):
        with placeholder_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            recs.append(dryrun.hamlet_pane_step(mesh))
            if not multi:
                recs += [dryrun.lower_cell(LM_ARCH, c, mesh)
                         for c in LOWER_CELLS]
                recs += [dryrun.lower_cell(a, c, mesh)
                         for a, c in LOWER_REPAIRED]
    for r in recs:
        log(f"[lower] {json.dumps(r)}")
        if r["status"] != "ok":
            fail(f"lower: {r['arch']} {r['cell']} on {r['mesh']}: "
                 f"{r['status']}")
    return {f"{r['arch']}/{r['cell']}/{r['mesh']}": r for r in recs}


def lower_flops(torch, np, dev) -> dict:
    """The proof's FLOPs of gemma2-2b's train step at the ``train`` phase's
    batch on a 1-rank world, against ``FlopCounterMode`` over one real
    ``train_step_fn`` step at full width on the card, and against
    ``train_flops``: the first two must be equal, the ratio to the third
    within 0.99-1.01."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import placeholder_world
    from repro_torch.models import LM, train_step_fn
    from repro_torch.train import AdamW
    from repro_torch.train.data import SyntheticLM

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    with placeholder_world(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        rec = dryrun.lower_step(LM_ARCH, cfg, TRAIN_SEQ, TRAIN_BATCH,
                                "train", mesh)
    trace_s = time.perf_counter() - t0
    model = LM(cfg, device=dev, seed=0)
    opt = AdamW(lr=TRAIN_LR)
    state = opt.init(dict(model.named_parameters()))
    batch = _on(torch, np, SyntheticLM(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                       seed=0).batch_for_step(0), dev)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        loss = float(train_step_fn(opt)(model, state, batch))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    card = fc.get_total_flops()
    analytic = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    total = analytic["bf16"] + analytic["f32"]
    ratio = rec["flops"] / total
    log(f"[lower] {LM_ARCH} train step, batch {TRAIN_BATCH} x {TRAIN_SEQ}: "
        f"proof on a 1-rank world {rec['flops']:.6e} FLOPs (its unsharded "
        f"count {rec['flops_exact']:.6e}; traced in {trace_s:.1f} s), "
        f"FlopCounterMode over a real step on the card {card:.6e} (loss "
        f"{loss:.6f}, {step_s:.1f} s under the counter), train_flops "
        f"{total:.6e}: ratio {ratio:.6f}")
    del model, state
    torch.cuda.empty_cache()
    if not (rec["flops"] == card == rec["flops_exact"]):
        fail(f"lower: proof {rec['flops']} / unsharded {rec['flops_exact']} "
             f"FLOPs against the card's FlopCounterMode {card}")
    if not 0.99 <= ratio <= 1.01 or not math.isfinite(loss):
        fail(f"lower: FLOP ratio to train_flops {ratio}, loss {loss}")
    return {"proof_flops": rec["flops"], "unsharded_flops": rec["flops_exact"],
            "card_flops": card, "train_flops": total, "ratio": ratio,
            "trace_s": trace_s, "loss": loss}


def lower_pane(torch, np, dev) -> dict:
    """The pane step's body at its full shape on the card, seeded real
    inputs (``dryrun.pane_inputs``: counts, masks of density
    ``dryrun.PANE_DENSITY``), the twins computing it as the reference
    does: its device ms (CUDA events, median of 5 after a warm-up); then
    the masked part held against ``propagate_batched(backend="cuda")`` and
    the dense part against the dense kernel: finite entries within
    ``RTOL_PANE``, and each kernel's non-finite pattern equal to its np
    oracle's (the twins' patterns counted).  Those two launches are the
    phase's."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import dryrun

    args = dryrun.pane_inputs(PANE_DP, device=dev, seed=0)
    base_d, base_m, masks = args[:3]
    dryrun.pane_step(*args)
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        coef_sum, counts_sum = dryrun.pane_step(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    coef_d, coef_m = dryrun.pane_parts(base_d, base_m, masks)
    fns = _kernel_fns()
    _reset(*fns.values())
    k_m = ops.propagate_batched(base_m, masks, backend="cuda")
    k_d = ops.propagate_dense_batched(base_d, backend="cuda")
    torch.cuda.synchronize()
    launches = _launches()
    host = [x.to("cpu", copy=True).numpy() for x in (base_m, masks, base_d)]
    with np.errstate(over="ignore", invalid="ignore"):
        o_m = ref.numpy_prefix_propagate_batched(host[0], host[1])
        o_d = ref.prefix_propagate_dense_np_batched(host[2])
    G, b, B, k, C = dryrun.PANE_SHAPE
    log(f"[lower] pane step on the card: G {G} (dense {base_d.shape[0]}, "
        f"masked {base_m.shape[0]}, density {dryrun.PANE_DENSITY}), b {b}, "
        f"B {B}, k {k}, C {C}, f32: {ms:.4f} ms (median of 5, CUDA events; "
        f"{[round(t, 4) for t in times]}); sums finite "
        f"{bool(torch.isfinite(coef_sum).any())}/"
        f"{bool(torch.isfinite(counts_sum).any())}")
    out = {"ms": ms, "times_ms": times, "launches": launches,
           "masked": _pane_held(np, "masked (blocked twin vs the masked "
                                "kernel; np oracle the f32 row loop)",
                                coef_m, k_m, o_m),
           "dense": _pane_held(np, "dense (f32 twin vs the dense kernel; np "
                               "oracle the f64-weight closed form)",
                               coef_d, k_d, o_d)}
    for part in ("masked", "dense"):
        h = out[part]
        if (h["max_rel_err"] > RTOL_PANE or h["both_finite"] == 0
                or h["kernel_vs_oracle_pattern_mismatch"]):
            fail(f"lower: pane step {part}: finite entries beyond "
                 f"{RTOL_PANE}, none finite, or the kernel's non-finite "
                 f"pattern departs from its np oracle's: {h}")
    return out


def phase_lower(torch, np) -> dict:
    """The lowering proofs (``repro_torch.launch.dryrun``, ``launch.
    hlo_analysis``; placeholder-world traces need no GPU and run in this
    process) and the pane step on the card: the traces, the train step's
    FLOPs against the card's, the pane step held against both kernels.
    Sets ``allow_bf16_reduced_precision_reduction = False`` as the ``lm``
    phase does, and ``allow_tf32 = False`` as ``main`` does (the pane
    step's float32 products in full float32)."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    out = {"traces": lower_traces(torch), "flops": lower_flops(torch, np, dev),
           "pane": lower_pane(torch, np, dev)}
    out["launches"] = out["pane"]["launches"]
    log(f"[lower] kernel launches over the phase's path: {out['launches']}")
    if not all(out["launches"].values()):
        fail(f"lower: a kernel did not launch on the pane step: "
             f"{out['launches']}")
    return out


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
    base_res = phase_baselines(torch, np)
    obs_res = phase_obs(torch, np)
    stream_res = phase_stream(torch, np, main_res)
    t_phase = time.perf_counter()
    shards_res = phase_shards(torch, np)
    log(f"[shards] phase wall {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    serve_res = phase_serve(torch, np)
    log(f"[serve] phase wall {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    lm_res = phase_lm(torch, np)
    log(f"[lm] phase wall {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    width_res = phase_width(torch, np)
    log(f"[width] phase wall {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    train_res = phase_train(torch, np)
    log(f"[train] phase wall {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    train_width_res = phase_train_width(torch, np)
    log(f"[train_width] phase wall {time.perf_counter() - t_phase:.1f} s "
        f"(the script so far {time.perf_counter() - t0:.1f} s)")
    t_phase = time.perf_counter()
    dist_res = phase_dist(torch, np, main_res)
    log(f"[dist] phase wall {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    lower_res = phase_lower(torch, np)
    log(f"[lower] phase wall {time.perf_counter() - t_phase:.1f} s")
    check = next(c for c in kernels["hamlet_propagate"]["checks"]
                 if c["case"] == "solved rows in global memory")
    log(f"[baselines] the masked kernel's global-memory variant: (1, "
        f"{base_res['paper']['n_max']}, 1) at "
        f"{base_res['greta_shape']['ms']:.6f} ms; the kernels phase's "
        f"check at {tuple(check['shape'])}: {check['ms']:.6f} ms")

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "repro."))
                    or m == "repro")
    if leaked:
        fail(f"imported the JAX package or jax: {leaked[:5]}")
    for name, e in kernels.items():
        e["launches"] = main_res["launches"][name]
        e["main_path"] = main_res["shapes"][name]
        e["shards_launches"] = shards_res["launches"][name]
        e["serve_launches"] = serve_res["launches"][name]
        e["lm_launches"] = lm_res["launches"][name]
        e["width_launches"] = width_res["launches"][name]
        e["train_launches"] = train_res["launches"][name]
        e["train_width_launches"] = train_width_res["launches"][name]
        e["dist_launches"] = dist_res["launches"][name]
        e["lower_launches"] = lower_res["launches"][name]
    hp = kernels["hamlet_propagate"]
    hp["greta"] = dict(base_res["greta_shape"],
                       launches=base_res["launches"])
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(kernels.values()),
                      "card": card, "config": MAIN_CONFIG,
                      "baselines": {k: base_res[k] for k in
                                    ("finite_cut", "large_finite", "paper")},
                      "obs": obs_res, "stream": stream_res,
                      "shards": shards_res, "serve": serve_res,
                      "lm": lm_res, "width": width_res,
                      "train": train_res, "train_width": train_width_res,
                      "dist": dist_res,
                      "lower": lower_res},
                     default=str), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
