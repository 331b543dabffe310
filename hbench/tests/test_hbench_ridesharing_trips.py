"""The trip-outcome cell, ``ridesharing-trips.replay``: it is found by name
with its configuration, mix and metrics; its three negation readers (the
plan walk's negation clock, the gates finalize applied, the share of fold
rounds that carry one) read what they should and nothing where there is
nothing; a run with the negation gates dropped reads as not correct; the
float32 control fails its limit at a test's size; and a traced run on the
CPU reports every per-layer metric the cell lists but the device trace's."""

import json

import numpy as np
import pytest
from conftest import ROOT, tiny_copy

from hbench import control, run, streamgen

CELL = "ridesharing-trips.replay"
NEW = ("plan_neg_us_per_event.replay", "neg_gates_per_kevent.replay",
       "neg_round_pct.replay")
STATS = {"plan_neg_s": 0.25, "neg_gates": 3_000, "neg_rounds": 150,
         "fold_rounds": 600}


@pytest.fixture(scope="module")
def trips_root(tmp_path_factory):
    """The tiny copy with this configuration at its own density: then the
    first measured segment, which every run checks however few it
    completes, holds Pickups after trends (at the tiny copy's density a
    40-tick segment often has neither)."""
    root = tiny_copy(tmp_path_factory.mktemp("trips"))
    f = root / "hbench" / "configs" / "ridesharing-trips.json"
    cfg = json.loads(f.read_text())
    cfg["events_per_group_minute"] = json.loads(
        (ROOT / "hbench" / "configs" / "ridesharing-trips.json")
        .read_text())["events_per_group_minute"]
    f.write_text(json.dumps(cfg))
    return root


def _rec(**stats):
    return {"events": 100_000, "window_s": 10.0, "setup_s": 1.0,
            "stats": stats, "kernel_shapes": {}, "device": None}


def _read(name, rec):
    return run.reader(name, ROOT)(rec)


def test_readers():
    rec = _rec(**STATS)
    assert _read(NEW[0], rec) == pytest.approx(2.5)
    assert _read(NEW[1], rec) == pytest.approx(30.0)
    assert _read(NEW[2], rec) == pytest.approx(25.0)
    # no event in the window, no round folded
    assert _read(NEW[0], dict(rec, events=0)) is None
    assert _read(NEW[1], dict(rec, events=0)) is None
    assert _read(NEW[2], _rec(**dict(STATS, fold_rounds=0))) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_program_without_the_field(name):
    """The parent of the change that counts them: no reading, no error."""
    assert _read(name, _rec(plan_s=1.0, bursts=10, shared_bursts=5)) is None


def test_the_cell_is_found_by_name():
    spec = run.load_cell(CELL, ROOT)
    cfg = spec["cfg"]
    assert cfg["name"] == "ridesharing-trips"
    assert cfg["pattern"] == "seq_kleene_tail"
    assert (cfg["within"], cfg["slide"]) == (30, 5)
    assert {q["within"] for q in cfg["queries"]} == {30, 20}
    assert spec["mix"]["driver"] == "replay"
    assert spec["mix"]["districts"] == 32
    assert spec["cell"]["chips"] == 1
    assert {m["name"] for m in spec["end_to_end"]} == {"events_per_s",
                                                       "setup_s"}
    layer = {m["name"]: m for m in spec["per_layer"]}
    assert (layer[NEW[0]]["layer"], layer[NEW[0]]["moves"]) == \
        ("plan", "events_per_s")
    for name in NEW[1:]:
        assert (layer[name]["layer"], layer[name]["moves"]) == \
            ("finalize", "events_per_s")
    for name in NEW:
        assert layer[name]["workloads"] == [CELL]
    for name in ("masked_propagate_roofline", "finalize_us_per_event.replay",
                 "stacked_graphlet_pct.replay"):
        assert name in layer
    assert "plan_edge_us_per_event.replay" not in layer
    assert "event_snapshot_pct.replay" not in layer
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (c,) = [c for c in bench["configs"] if c["name"] == "ridesharing-trips"]
    assert c["reduced"] == cfg["reduced"] == ["stream_minutes"]


@pytest.mark.parametrize("seed", [7, 2**33 + 1])
def test_float32_control_fails_the_limit(seed):
    """Two districts of the cell's density, two stream-minutes: float32
    loses windows to overflow, float64 holds them."""
    spec = run.load_cell(CELL, ROOT)
    cfg, limit = spec["cfg"], spec["mix"]["limits"]["max_rel_gap"]
    s = streamgen.district_stream(
        seed=seed, segment=0, minutes=2,
        events_per_minute=2 * cfg["events_per_group_minute"], districts=2,
        n_types=len(cfg["schema"]["types"]),
        type_weights=cfg["type_weights"], burstiness=cfg["burstiness"],
        n_attrs=len(cfg["schema"]["attrs"]))
    r = control.reading(cfg, limit, s, list(range(0, 91, 5)))
    assert r["gap"] > limit and r["over_limit"] > 0
    assert r["values_lost_to_float32"] > 0


def test_dropped_negation_gate_reads_not_correct(trips_root, monkeypatch):
    """Finalize's host rounds skip every negation gate: trends that end
    before a Pickup stay counted."""
    from repro_torch.core import fold_exec

    monkeypatch.setattr(fold_exec._CtxState, "apply_neg",
                        lambda self, row, hits: None)
    out = run.run_cell(CELL, 2**31 + 5, 1.0, False, backend="torch",
                       device="cpu", root=trips_root)
    assert not out["correct"]
    assert out["failed"] > 0


def test_a_traced_cpu_run_reports_the_cell(trips_root, monkeypatch):
    from hbench import drivers

    monkeypatch.setattr(drivers, "_trace", lambda ctx, obs: None)
    out = run.run_cell(CELL, 2**31 + 3, 0.5, True, backend="torch",
                       device="cpu", root=trips_root)
    assert out["correct"]
    got = out["metrics"]
    for name in NEW:
        assert got[name]["value"] > 0, name
    assert got["neg_round_pct.replay"]["value"] < 100
    spec = run.load_cell(CELL, trips_root)
    # all but the readers of the device trace, which the CPU run lacks
    want = {m["name"] for m in spec["per_layer"]
            if m["source"] != "device_trace"}
    assert want <= set(got)
    assert np.isfinite([v["value"] for v in got.values()]).all()
