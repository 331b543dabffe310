"""The step readers (the program's ``RunStats`` step clocks and counts)
on hand-made records: what each reads, and nothing where there is nothing
to read (no event in the window, or a program without the field); every
one has an entry in ``BENCHMARK.json`` and a reader; and a traced run of
each cell on the CPU reports its own."""

import json

import pytest
from conftest import ROOT, cells

from hbench import drivers, run

# metric -> the RunStats field it reads, and its scale per event
PER_EVENT = {
    "plan_prologue_us_per_event.replay": ("plan_prologue_s", 1e6),
    "plan_decide_us_per_event.replay": ("plan_decide_s", 1e6),
    "plan_build_us_per_event.replay": ("plan_build_s", 1e6),
    "execute_stage_us_per_event.replay": ("execute_stage_s", 1e6),
    "execute_launch_us_per_event.replay": ("execute_launch_s", 1e6),
    "execute_wait_us_per_event.replay": ("execute_wait_s", 1e6),
    "h2d_bytes_per_event.replay": ("execute_h2d_bytes", 1.0),
    "finalize_prep_us_per_event.replay": ("finalize_prep_s", 1e6),
    "finalize_rounds_us_per_event.replay": ("finalize_rounds_s", 1e6),
    "finalize_wait_us_per_event.replay": ("finalize_wait_s", 1e6),
    "ingress_us_per_event.open": ("ingress_s", 1e6),
    "admit_us_per_event.open": ("admit_s", 1e6),
}
GC = ("gc_pause_pct.replay", "gc_pause_pct.open")
NEW = sorted(PER_EVENT) + list(GC)

STATS = {"plan_s": 2.0, "execute_s": 0.5, "finalize_s": 0.25,
         "fold_s": 0.1, "bursts": 400, "shared_bursts": 100,
         "plan_prologue_s": 0.5, "plan_decide_s": 0.25, "plan_build_s": 0.75,
         "execute_stage_s": 0.125, "execute_launch_s": 0.25,
         "execute_wait_s": 0.125, "execute_h2d_bytes": 3_200_000,
         "execute_d2h_bytes": 1_600_000, "finalize_prep_s": 0.05,
         "finalize_rounds_s": 0.15, "finalize_wait_s": 0.05,
         "ingress_s": 0.2, "admit_s": 0.4, "gc_s": 1.5,
         "gc_collections": 300}


def _rec(**kw):
    rec = {"events": 100_000, "window_s": 10.0, "setup_s": 12.5,
           "stats": dict(STATS), "kernel_shapes": {}, "device": None}
    rec.update(kw)
    return rec


def _read(name, rec):
    return run.reader(name, ROOT)(rec)


@pytest.mark.parametrize("name", sorted(PER_EVENT))
def test_step_reader_per_event(name):
    field, scale = PER_EVENT[name]
    assert _read(name, _rec()) == pytest.approx(
        STATS[field] / 100_000 * scale)
    assert _read(name, _rec(events=0)) is None
    # a program that predates the step clocks: no reading, no error
    stats = dict(STATS)
    del stats[field]
    assert _read(name, _rec(stats=stats)) is None


@pytest.mark.parametrize("name", GC)
def test_gc_pause_share(name):
    assert _read(name, _rec()) == pytest.approx(15.0)
    assert _read(name, _rec(events=0)) is None
    stats = dict(STATS)
    del stats["gc_s"]
    assert _read(name, _rec(stats=stats)) is None


def test_every_new_metric_has_an_entry_and_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    replay = {c for c in cells() if c.endswith(".replay")}
    for name in NEW:
        m = entries[name]
        assert (ROOT / "hbench" / "metrics" / f"{name}.py").is_file()
        assert callable(run.reader(name, ROOT))
        mine = set(m["workloads"])
        if name.endswith(".replay"):
            assert mine == replay and m["moves"] == "events_per_s"
        else:
            assert mine == {"ridesharing-w1.open"}
            assert m["moves"] == "latency_p50_ms"


@pytest.mark.parametrize("cell", cells())
def test_a_traced_cpu_run_reports_its_step_metrics(tiny_root, cell,
                                                   monkeypatch):
    """The program's ``Observability`` on, no device trace (the profiler
    traces a card): every step metric of the cell is reported."""
    monkeypatch.setattr(drivers, "_trace", lambda ctx, obs: None)
    out = run.run_cell(cell, 5, 0.5, True, backend="torch", device="cpu",
                       root=tiny_root)
    assert out["correct"]
    spec = run.load_cell(cell, tiny_root)
    want = {m["name"] for m in spec["per_layer"]} & set(NEW)
    assert want and want <= set(out["metrics"])
    for name in want:
        assert out["metrics"][name]["value"] >= 0, name
