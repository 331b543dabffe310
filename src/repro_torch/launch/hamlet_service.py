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

The other modes of the JAX package's launcher — ``--overload``,
``--shards``, ``--serve`` and ``--listen``/``--connect`` — are not ported
yet and exit with an error.
"""

from __future__ import annotations

import argparse
import time

from ..core.engine import HamletRuntime
from ..core.optimizer import AlwaysShare, DynamicPolicy, FlopPolicy, NeverShare
from ..core.pattern import EventType, Kleene, Not, Seq
from ..core.query import Pred, Query, Workload, agg_avg, agg_sum, count_star
from ..obs import PHASES, Observability
from ..streams.generator import RIDESHARING_SCHEMA, ridesharing_stream

POLICIES = {"dynamic": DynamicPolicy, "always": AlwaysShare,
            "never": NeverShare, "flop": FlopPolicy}

# modes of the JAX package's launcher that this port does not have yet
UNPORTED = ("overload", "serve", "shards", "listen", "connect")


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
    for flag in ("overload", "serve"):
        ap.add_argument(f"--{flag}", action="store_true",
                        help="not yet ported")
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


def main(argv=None):
    args = parse_args(argv)
    asked = [f for f in UNPORTED if getattr(args, f)]
    if asked:
        raise SystemExit(f"--{asked[0]}: not yet ported to the PyTorch/CUDA "
                         "package (use repro.launch.hamlet_service)")
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
