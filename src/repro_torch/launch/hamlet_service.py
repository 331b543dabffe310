"""HAMLET streaming service command line (PyTorch/CUDA port).

Processes a bursty event stream pane-by-pane through the HAMLET runtime on
the GPU (group partitions are data-parallel; this single-host launcher
iterates them):

    PYTHONPATH=src python -m repro_torch.launch.hamlet_service --minutes 2 \
        --events-per-minute 500 --policy dynamic

``--backend`` picks the kernel backend (``cuda``: the hand-written kernels,
the default; ``torch``: their plain PyTorch versions; ``np``: the numpy
host oracles) and ``--device`` the torch device (default ``cuda:0``; the
run fails when no GPU is present unless ``--backend np`` or ``--device
cpu`` is given).

``--trace out.jsonl`` attaches the observability layer
(:class:`repro_torch.obs.Observability`): pane-lifecycle spans are exported
as Chrome-trace JSONL (convert with ``python -m repro_torch.obs.trace
out.jsonl out.json`` and load in Perfetto), and the run report gains the
per-phase span-sum vs ``RunStats`` check plus the sharing-decision audit
summary; ``--trace-sample N`` traces every Nth pane's track.

``--overload`` switches to the bounded-latency runtime
(:class:`repro_torch.overload.OverloadRuntime`): an overload scenario
stream (rate ramp + flash crowd) is offered at ``--offered-x`` times the
capacity calibrated on the same backend and processed through ingress
backpressure, per-pane admission control, the ``--shed-policy`` shedding
policy and the PID latency controller; ``--recall`` adds the detection
recall against the unshed run on the same backend:

    PYTHONPATH=src python -m repro_torch.launch.hamlet_service --overload \
        --offered-x 2 --shed-policy benefit_weighted --recall

The other modes of the JAX package's launcher — ``--shards``, ``--serve``
and ``--listen``/``--connect`` — are not ported yet and exit with an error.
"""

from __future__ import annotations

import argparse
import time

from ..core.engine import HamletRuntime
from ..core.optimizer import AlwaysShare, DynamicPolicy, FlopPolicy, NeverShare
from ..core.pattern import EventType, Kleene, Not, Seq
from ..core.query import Pred, Query, Workload, agg_avg, agg_sum, count_star
from ..obs import PHASES, Observability
from ..streams.generator import (RIDESHARING_SCHEMA, OverloadStreamConfig,
                                 overload_stream, ridesharing_stream)
from .fig_overload import detection_recall

POLICIES = {"dynamic": DynamicPolicy, "always": AlwaysShare,
            "never": NeverShare, "flop": FlopPolicy}

# modes of the JAX package's launcher that this port does not have yet
UNPORTED = ("serve", "shards", "listen", "connect")


def ridesharing_workload(n_queries: int = 3) -> Workload:
    """The paper's Fig. 1 workload shape, replicated/perturbed to n queries."""
    R, T, P, D, C = (EventType(t) for t in
                     ("Request", "Travel", "Pickup", "Dropoff", "Cancel"))
    qs = [
        Query("q1", Seq(R, Kleene(T), Not(P)),
              aggs=(count_star(), agg_sum("Travel", "duration")),
              within=30, slide=5, group_by=("district",)),
        Query("q2", Seq(R, Kleene(T), D),
              aggs=(count_star(), agg_avg("Travel", "speed")),
              preds={"Request": [Pred("rtype", "<", 5.0)]},
              within=30, slide=5, group_by=("district",)),
        Query("q3", Seq(R, Kleene(T), C),
              aggs=(count_star(), agg_sum("Travel", "duration")),
              preds={"Travel": [Pred("speed", "<", 6.0)]},
              within=20, slide=5, group_by=("district",)),
    ]
    out = list(qs)
    i = 0
    while len(out) < n_queries:
        q = qs[i % 3]
        out.append(Query(f"q{len(out) + 1}", q.pattern, aggs=q.aggs,
                         preds={"Travel": [Pred("speed", "<",
                                                2.0 + (i % 8))]},
                         within=q.within, slide=q.slide,
                         group_by=q.group_by))
        i += 1
    return Workload(RIDESHARING_SCHEMA, out)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=int, default=2)
    ap.add_argument("--events-per-minute", type=int, default=500)
    ap.add_argument("--queries", type=int, default=3)
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--policy", choices=list(POLICIES), default="dynamic")
    ap.add_argument("--backend", default="cuda",
                    choices=["cuda", "torch", "np"])
    ap.add_argument("--device", default=None,
                    help="torch device for the cuda/torch backends "
                         "(default cuda:0)")
    ap.add_argument("--overload", action="store_true",
                    help="bounded-latency runtime on an overload scenario")
    ap.add_argument("--offered-x", type=float, default=2.0,
                    help="offered load as a multiple of calibrated capacity")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="pane latency SLO (default: the real-time pane "
                         "budget)")
    ap.add_argument("--shed-policy", default="benefit_weighted",
                    choices=["none", "drop_tail", "random",
                             "benefit_weighted"])
    ap.add_argument("--recall", action="store_true",
                    help="also compute recall vs the unshedded run")
    ap.add_argument("--serve", action="store_true", help="not yet ported")
    ap.add_argument("--shards", type=int, default=0, help="not yet ported")
    for flag in ("listen", "connect"):
        ap.add_argument(f"--{flag}", default=None, help="not yet ported")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="attach the observability layer and export the "
                         "pane-span trace as Chrome-trace JSONL")
    ap.add_argument("--trace-sample", type=int, default=1,
                    help="per-pane track sampling: trace every Nth pane")
    return ap.parse_args(argv)


def _make_obs(args) -> Observability | None:
    if not args.trace:
        return None
    return Observability(sample=args.trace_sample)


def _obs_report(obs: Observability, path: str, stats) -> None:
    """Export the trace and print the observability run report: span sums
    checked against the RunStats phase timers, plus the audit summary."""
    n = obs.export_trace(path)
    print(f"trace: {n} events -> {path} "
          f"(dropped={obs.tracer.dropped}, sample={obs.tracer.sample}); "
          f"perfetto: python -m repro_torch.obs.trace {path} "
          f"{path}.chrome.json")
    totals = obs.phase_totals()
    for ph in PHASES:
        span_s = totals.get(ph, 0.0)
        stat_s = getattr(stats, f"{ph}_s")
        dev = abs(span_s - stat_s) / stat_s * 100 if stat_s else 0.0
        print(f"  {ph:8s} spans={span_s * 1e3:9.2f} ms "
              f"stats={stat_s * 1e3:9.2f} ms (dev {dev:.2f}%)")
    if obs.audit is not None:
        a = obs.audit.summary()
        print(f"audit: {a['decisions']} decisions "
              f"(shared={a['shared']} split={a['split']} "
              f"flips={a['flips']} sites={a['sites']} "
              f"dropped={a['dropped']})")


def run_default(args: argparse.Namespace):
    """The default mode: the ridesharing workload over a bursty
    ridesharing stream, with the observability layer attached when
    ``--trace`` is given (``runtime.obs``).  Returns ``(results, runtime,
    stream, wall_s)``."""
    wl = ridesharing_workload(args.queries)
    batch = ridesharing_stream(events_per_minute=args.events_per_minute,
                               minutes=args.minutes, n_groups=args.groups)
    rt = HamletRuntime(wl, policy=POLICIES[args.policy](),
                       backend=args.backend, device=args.device,
                       obs=_make_obs(args))
    t0 = time.time()
    res = rt.run(batch, t_end=args.minutes * 60)
    return res, rt, batch, time.time() - t0


def run_overload(args) -> dict:
    """The ``--overload`` mode: calibrate the capacity on the run's own
    backend, offer the scenario at ``--offered-x`` of it and report the
    per-pane latency, shedding and error certificates (and, with
    ``--recall``, the recall against the unshed run on the same backend).
    Returns the metrics summary with ``capacity``, ``slo_ms`` and
    ``recall`` added."""
    from ..overload import OverloadConfig, OverloadRuntime

    wl = ridesharing_workload(args.queries)
    t_end = args.minutes * 60
    stream = overload_stream(OverloadStreamConfig(
        schema=RIDESHARING_SCHEMA,
        base_events_per_minute=args.events_per_minute,
        minutes=args.minutes, ramp_to=1.5,
        flash_crowds=((t_end // 3, 20, 3.0),),
        n_groups=args.groups, type_weights=(1, 1, 6, 1, 1, 1)))
    on = dict(backend=args.backend, device=args.device)

    # calibrate capacity (events/s the unshedded engine sustains on this
    # backend; its runs end on the host fetch) on a prefix
    sample = stream.time_slice(0, min(60, t_end))
    cal = HamletRuntime(wl, policy=POLICIES[args.policy](), **on)
    t0 = time.perf_counter()
    cal.run(sample, t_end=min(60, t_end))
    capacity = len(sample) / max(time.perf_counter() - t0, 1e-9)

    pane = cal.pane
    tick_seconds = (len(stream) / t_end) / (args.offered_x * capacity)
    slo_ms = args.slo_ms or pane * tick_seconds * 1e3  # default: real time
    cfg = OverloadConfig(
        slo_ms=slo_ms, shed_policy=args.shed_policy,
        tick_seconds=tick_seconds,
        pane_budget_events=int(capacity * pane * tick_seconds))
    obs = _make_obs(args)
    ort = OverloadRuntime(wl, cfg, policy=POLICIES[args.policy](), obs=obs,
                          **on)
    res = ort.run(stream, t_end)
    s = ort.metrics.summary()
    if obs is not None:
        _obs_report(obs, args.trace, ort.stats)
    print(f"offered_x={args.offered_x} capacity={capacity:.0f} ev/s "
          f"slo={slo_ms:.2f} ms policy={args.shed_policy} "
          f"backend={args.backend} device={ort.rt.device}")
    print(f"offered={s['offered']} admitted={s['admitted']} "
          f"shed={s['shed']} ({100 * s['shed_frac']:.1f}%) "
          f"ingress_dropped={ort.queue.dropped} rejected={ort.queue.rejected}")
    print(f"pane proc p50={s['p50_proc_ms']:.2f} ms "
          f"p99={s['p99_proc_ms']:.2f} ms "
          f"({s['p99_proc_ms'] / slo_ms:.2f}x slo) "
          f"| e2e p99={s['p99_lat_ms']:.2f} ms "
          f"mean_shed_ratio={s['mean_shed_ratio']:.2f}")
    for name, rep in sorted(ort.accountant.report().items()):
        print(f"  {name}: shed kleene={rep.shed_kleene} "
              f"critical={rep.shed_critical} negative={rep.shed_negative} "
              f"subset_guarantee={rep.subset_guarantee}")
    recall = None
    if args.recall:
        truth = HamletRuntime(wl, policy=POLICIES[args.policy](), **on).run(
            stream, t_end)
        recall, n = detection_recall(truth, res)
        print(f"detection recall={recall:.3f} over {n} windows")
    return dict(s, capacity=capacity, slo_ms=slo_ms, recall=recall)


def main(argv=None):
    args = parse_args(argv)
    asked = [f for f in UNPORTED if getattr(args, f)]
    if asked:
        raise SystemExit(f"--{asked[0]}: not yet ported to the PyTorch/CUDA "
                         "package (use repro.launch.hamlet_service)")
    if args.overload:
        return run_overload(args)
    res, rt, batch, dt = run_default(args)
    s = rt.stats
    if rt.obs is not None:
        _obs_report(rt.obs, args.trace, s)
    print(f"policy={args.policy} backend={args.backend} device={rt.device} "
          f"events={len(batch)} windows={s.windows_emitted} "
          f"results={len(res)}")
    print(f"wall={dt:.3f}s throughput={len(batch) / dt:.0f} ev/s "
          f"latency/pane={1e3 * dt / max(1, s.panes):.2f} ms")
    print(f"bursts={s.bursts} shared={s.shared_bursts} "
          f"graphlets={s.graphlets} snapshots={s.snapshots_created} "
          f"propagated={s.snapshots_propagated} decisions={s.decisions}")
    some = sorted(res.items())[:5]
    for k, v in some:
        print(" ", k, {a: round(x, 2) for a, x in v.items()})


if __name__ == "__main__":
    main()
