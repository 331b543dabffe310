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
summary; ``--trace-sample N`` traces every Nth pane's track.  The trace
holds the steps inside each phase as ``"step"`` spans and, first, a
``clock_sync`` event pairing its origin on ``perf_counter`` and the Unix
epoch.  To read it on one timeline with a ``torch.profiler`` trace of
the same run, export it on the profiler's clock instead:
``obs.tracer.export_jsonl(path, epoch_ns=base)``, with ``base`` the
``baseTimeNanoseconds`` of the profiler's ``export_chrome_trace`` file,
whose ``ts`` then share one axis with it: put both event lists in one
``traceEvents`` file for Perfetto.

``--overload`` switches to the bounded-latency runtime
(:class:`repro_torch.overload.OverloadRuntime`): an overload scenario
stream (rate ramp + flash crowd) is offered at ``--offered-x`` times the
capacity calibrated on the same backend and processed through ingress
backpressure, per-pane admission control, the ``--shed-policy`` shedding
policy and the PID latency controller; ``--recall`` adds the detection
recall against the unshed run on the same backend:

    PYTHONPATH=src python -m repro_torch.launch.hamlet_service --overload \
        --offered-x 2 --shed-policy benefit_weighted --recall

``--shards N --tenants M`` runs the sharded multi-tenant service tier
(:mod:`repro_torch.shardsvc`): M tenants' streams compose into one stream,
a consistent-hash router places tenant groups on N shard workers (each its
own runtime on the backend and device asked for), admission happens at
the router, and per-shard frontiers negotiate fleet progress through the
aligned-epoch coordinator.  ``--flash-tenant`` aims a flash crowd at one
tenant, ``--rebalance`` moves that tenant's lead group to the least-busy
shard mid-stream:

    PYTHONPATH=src python -m repro_torch.launch.hamlet_service --shards 4 \
        --tenants 8 --minutes 2 --flash-tenant 0 --rebalance

``--serve --sessions N`` runs the asynchronous serving front-end
(:mod:`repro_torch.serve`): N client sessions trickle events in on real
threads, the continuous-batching scheduler merges them by watermark into
the K-pane micro-batched flush path, and each session's inbox receives
the emissions for its tenant's groups, with per-session delivery-latency
histograms in the summary:

    PYTHONPATH=src python -m repro_torch.launch.hamlet_service --serve \
        --sessions 16 --tenants 4 --minutes 2

``--listen HOST:PORT`` puts the same front-end on a socket (the JAX
package's wire protocol, byte for byte) and waits for ``--sessions``
clients; ``--connect HOST:PORT --session-index i`` runs one paced client
session from another process (a client runs no engine, so it needs no
``--backend``):

    PYTHONPATH=src python -m repro_torch.launch.hamlet_service \
        --listen 127.0.0.1:7431 --sessions 2 --tenants 2 &
    for i in 0 1; do
        PYTHONPATH=src python -m repro_torch.launch.hamlet_service \
            --connect 127.0.0.1:7431 --sessions 2 --session-index $i \
            --tenants 2 &
    done
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
    ap.add_argument("--serve", action="store_true",
                    help="async serving front-end: concurrent trickle "
                         "sessions merged into shared micro-batched flushes")
    ap.add_argument("--sessions", type=int, default=8,
                    help="concurrent client sessions for --serve; expected "
                         "session count for --listen/--connect")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="serve the front-end on a real socket and wait "
                         "for --sessions clients")
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="run one socket client session against --listen")
    ap.add_argument("--session-index", type=int, default=0,
                    help="which deterministic session split this "
                         "--connect client drives")
    ap.add_argument("--credit-window", type=int, default=2048,
                    help="per-session event credit window for --listen")
    ap.add_argument("--pace-s", type=float, default=0.001,
                    help="--connect inter-chunk pacing sleep")
    ap.add_argument("--shards", type=int, default=0,
                    help="run the sharded multi-tenant service with N shards")
    ap.add_argument("--tenants", type=int, default=4,
                    help="tenant count for the sharded service and serving")
    ap.add_argument("--groups-per-tenant", type=int, default=2)
    ap.add_argument("--rate-skew", type=float, default=0.0,
                    help="Zipf exponent of per-tenant rates (0 = uniform)")
    ap.add_argument("--flash-tenant", type=int, default=None,
                    help="aim a flash crowd at this tenant")
    ap.add_argument("--rebalance", action="store_true",
                    help="move the hot tenant's lead group to the "
                         "least-busy shard mid-stream")
    ap.add_argument("--admission", default="global_fixed",
                    choices=["none", "global_fixed", "per_shard"],
                    help="router admission mode for the sharded service")
    ap.add_argument("--fixed-shed", type=float, default=None,
                    help="fixed router shed ratio (global_fixed admission)")
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


def run_sharded(args) -> dict:
    """The ``--shards`` mode: the tenant stream through a
    :class:`~repro_torch.shardsvc.ShardedHamletService` of ``--shards``
    workers on the backend asked for, fed pane by pane (with a rebalance
    mid-stream when ``--rebalance`` is given).  Returns the merged
    results."""
    from ..overload import OverloadConfig
    from ..shardsvc import ShardedHamletService, ShardServiceConfig
    from ..streams.generator import TenantStreamConfig, tenant_stream

    wl = ridesharing_workload(args.queries)
    t_end = args.minutes * 60
    stream = tenant_stream(TenantStreamConfig(
        schema=RIDESHARING_SCHEMA, n_tenants=args.tenants,
        groups_per_tenant=args.groups_per_tenant,
        base_events_per_minute=args.events_per_minute,
        minutes=args.minutes, rate_skew=args.rate_skew,
        flash_tenant=args.flash_tenant,
        flash=(t_end // 3, 30, 4.0),
        type_weights=(1, 1, 6, 1, 1, 1)))
    cfg = ShardServiceConfig(
        n_shards=args.shards, groups_per_tenant=args.groups_per_tenant,
        admission=args.admission,
        overload=OverloadConfig(shed_policy=args.shed_policy,
                                fixed_shed=args.fixed_shed,
                                micro_batch=4))
    svc = ShardedHamletService(wl, cfg, policy=POLICIES[args.policy](),
                               backend=args.backend, device=args.device)
    t0 = time.time()
    moved_at = None
    for c0 in range(0, t_end, svc.pane):
        svc.ingest(stream.time_slice(c0, c0 + svc.pane))
        if args.rebalance and moved_at is None and c0 >= t_end // 2:
            hot = args.flash_tenant or 0
            g = hot * args.groups_per_tenant
            busy = [w.busy_s for w in svc.workers]
            target = int(min(range(args.shards), key=busy.__getitem__))
            moved_at = svc.plan_rebalance(g, target)
            print(f"rebalance: group {g} -> shard {target} "
                  f"at boundary {moved_at}")
    svc.close()
    res = svc.results()
    dt = time.time() - t0
    col = svc.collect()
    st = svc.stats()
    print(f"shards={args.shards} tenants={args.tenants} "
          f"backend={args.backend} device={svc.device} "
          f"events={len(stream)} windows={st.windows_emitted} "
          f"results={len(res)} wall={dt:.3f}s")
    print(f"router: {col['router']['admission']} busy={svc.router_busy_s:.3f}s")
    print(f"alignment: {col['router']['alignment']}")
    for s in col["shards"]:
        ov = s["overload"]
        print(f"  shard {s['shard']}: busy={s['busy_s']:.3f}s "
              f"panes={ov['panes']} admitted={ov['admitted']} "
              f"p99_proc={ov['p99_proc_ms']:.2f} ms "
              f"launches={s['executor_launches']}")
    for name, rep in sorted(svc.error_report().items()):
        print(f"  {name}: shed kleene={rep.shed_kleene} "
              f"critical={rep.shed_critical} negative={rep.shed_negative} "
              f"subset_guarantee={rep.subset_guarantee}")
    return res


def _serving_stream(args):
    """The tenant stream every serving mode shares — deterministic, so a
    ``--connect`` client in another process rebuilds the identical split."""
    import numpy as np

    from ..core.events import EventBatch
    from ..streams.generator import TenantStreamConfig, tenant_stream

    stream = tenant_stream(TenantStreamConfig(
        schema=RIDESHARING_SCHEMA, n_tenants=args.tenants,
        groups_per_tenant=args.groups_per_tenant,
        base_events_per_minute=args.events_per_minute,
        minutes=args.minutes, rate_skew=args.rate_skew,
        type_weights=(1, 1, 6, 1, 1, 1)))
    if stream.seq is None:
        # original positions as producer seq: the serving merge then breaks
        # timestamp ties exactly like the batch run would
        stream = EventBatch(schema=stream.schema, type_id=stream.type_id,
                            time=stream.time, attrs=stream.attrs,
                            group=stream.group,
                            seq=np.arange(len(stream), dtype=np.int64))
    return stream


def _session_part(stream, i, n_sessions, tenants, groups_per_tenant):
    """Session ``i``'s (tenant, stream slice): sessions round-robin over
    tenants, each tenant's events stride-split across its sessions."""
    import numpy as np

    t = i % tenants
    lo, hi = t * groups_per_tenant, (t + 1) * groups_per_tenant
    idx = np.flatnonzero((stream.group >= lo) & (stream.group < hi))
    stride = max(1, n_sessions // tenants)
    return t, stream.select(idx[i // tenants::stride])


def _parse_hostport(s: str) -> tuple[str, int]:
    host, _, port = s.rpartition(":")
    return host or "127.0.0.1", int(port)


def _frontend(args, obs=None):
    """The serving front-end of ``--serve`` and ``--listen``: one shared
    overload runtime (K = 4) on the backend and device asked for."""
    from ..overload import OverloadConfig
    from ..serve import ServingFrontend

    return ServingFrontend(
        ridesharing_workload(args.queries), backend="overload",
        overload=OverloadConfig(shed_policy=args.shed_policy, micro_batch=4),
        np_backend=args.backend, device=args.device,
        groups_per_tenant=args.groups_per_tenant, obs=obs)


def run_serving(args) -> dict:
    """Asynchronous serving demo: ``--sessions`` concurrent trickle clients
    on real threads, merged by the continuous-batching scheduler into the
    shared K-pane flush path, results routed back per session.  Returns
    the drained results."""
    import threading

    stream = _serving_stream(args)
    obs = _make_obs(args)
    fe = _frontend(args, obs)
    n_sessions = max(1, args.sessions)
    parts, handles = [], []
    for i in range(n_sessions):
        t, part = _session_part(stream, i, n_sessions, args.tenants,
                                args.groups_per_tenant)
        parts.append(part)
        handles.append(fe.open_session(tenant=t))
    fe.start(interval_s=0.001)

    def trickle(h, part):
        hi = int(part.time.max()) + 1 if len(part) else 0
        for c0 in range(0, hi, fe.pane):
            h.submit(part.time_slice(c0, c0 + fe.pane))
            h.advance_to(min(c0 + fe.pane, hi))
            time.sleep(0.001)
        h.close()

    t0 = time.time()
    threads = [threading.Thread(target=trickle, args=(h, p))
               for h, p in zip(handles, parts)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    res = fe.drain()
    dt = time.time() - t0
    summ = fe.summary()
    if obs is not None:
        n = obs.export_trace(args.trace)
        print(f"trace: {n} events -> {args.trace} (serving spans + "
              f"per-session latency histograms in obs.collect)")
    lat = summ["latency_ms"]
    print(f"serve: sessions={n_sessions} tenants={len(summ['tenants'])} "
          f"backend={args.backend} device={fe.device} "
          f"events={summ['submitted']} windows={len(res)} wall={dt:.3f}s")
    print(f"deliveries={summ['deliveries']} sealed_to={summ['sealed_to']} "
          f"pump_cycles={summ['pump_cycles']} "
          f"latency p50={lat['p50']:.1f} ms p99={lat['p99']:.1f} ms")
    worst = sorted(summ["sessions"].items(),
                   key=lambda kv: -kv[1].get("p99_ms", 0.0))[:4]
    for sid, s in worst:
        print(f"  session {sid}: tenant={s['tenant']} "
              f"submitted={s['submitted']} delivered={s['delivered']} "
              f"p50={s.get('p50_ms', 0.0):.1f} ms "
              f"p99={s.get('p99_ms', 0.0):.1f} ms")
    return res


def run_listen(args) -> dict:
    """Wire-transport server: the serving front-end behind a real socket
    (:mod:`repro_torch.serve.transport`), zero-copy chunk ingest and
    credit-based backpressure.  Waits for ``--sessions`` clients to connect
    and close, then drains, reports and returns the results."""
    from ..serve import ServingServer

    host, port = _parse_hostport(args.listen)
    fe = _frontend(args, _make_obs(args))
    srv = ServingServer(fe, host, port, credit_window=args.credit_window)
    host, port = srv.start()
    n = max(1, args.sessions)
    print(f"listening on {host}:{port}; waiting for {n} session(s) "
          f"(connect with --connect {host}:{port} --session-index i)",
          flush=True)
    t0 = time.time()
    try:
        while True:
            sess = fe.summary()["sessions"]
            if len(sess) >= n and all(s["closed"] for s in sess.values()):
                break
            time.sleep(0.05)
        res = srv.drain()
    finally:
        srv.stop()
    dt = time.time() - t0
    summ, wire = fe.summary(), srv.summary()
    lat = summ["latency_ms"]
    print(f"serve: sessions={len(summ['sessions'])} backend={args.backend} "
          f"device={fe.device} events={summ['submitted']} "
          f"windows={len(res)} wall={dt:.3f}s")
    print(f"wire: frames_in={wire['frames_in']} "
          f"bytes_in={wire['bytes_in']} bytes_out={wire['bytes_out']} "
          f"disconnects={wire['disconnects']}")
    cr = wire["credit"]
    print(f"credit: window={cr['window']} granted={cr['granted']} "
          f"withheld={cr['withheld']} "
          f"staging_hwm={summ['staging']['hwm']}")
    print(f"latency p50={lat['p50']:.1f} ms p99={lat['p99']:.1f} ms "
          f"deliveries={summ['deliveries']}")
    return res


def run_connect(args) -> dict:
    """Wire-transport client: one session over a real socket, pacing its
    deterministic split of the tenant stream pane by pane.  Returns the
    END frame's results."""
    from ..serve import ServingClient

    host, port = _parse_hostport(args.connect)
    stream = _serving_stream(args)
    n = max(1, args.sessions)
    i = args.session_index % n
    tenant, part = _session_part(stream, i, n, args.tenants,
                                 args.groups_per_tenant)
    c = ServingClient(host, port, tenant=tenant)
    t0 = time.time()
    hi = int(part.time.max()) + 1 if len(part) else 0
    pane = c.pane or 10
    for c0 in range(0, hi, pane):
        c.submit(part.time_slice(c0, c0 + pane))
        c.advance_to(min(c0 + pane, hi))
        time.sleep(args.pace_s)
    c.close()
    got = list(c.deliveries())
    dt = time.time() - t0
    c.shutdown()
    res = c.results or {}
    print(f"session {c.sid}: tenant={tenant} submitted={len(part)} "
          f"deliveries={len(got)} windows={len(res)} wall={dt:.3f}s "
          f"blocked={c.blocked_s * 1e3:.1f} ms")
    return res


def main(argv=None):
    args = parse_args(argv)
    if args.listen:
        return run_listen(args)
    if args.connect:
        return run_connect(args)
    if args.serve:
        return run_serving(args)
    if args.shards > 0:
        return run_sharded(args)
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
