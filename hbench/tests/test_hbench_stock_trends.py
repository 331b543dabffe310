"""The stock cell, ``stock-trends.replay``: it is found by name with its
configuration, mix and metrics; its three plan-layer readers (edge masks'
clock and cells, the share of shared rows with an event-level snapshot)
read what they should and nothing where there is nothing; the float32
control fails its limit at a test's size; and a traced run on the CPU
reports every per-layer metric the cell lists but the device trace's."""

import json

import numpy as np
import pytest
from conftest import ROOT

from hbench import control, drivers, run, streamgen

CELL = "stock-trends.replay"
NEW = ("plan_edge_us_per_event.replay", "event_snapshot_pct.replay",
       "edge_mask_cells_per_event.replay")
STATS = {"plan_edge_s": 0.5, "edge_mask_cells": 4_000_000,
         "shared_rows": 800, "snapshot_rows": 200}


def _rec(**stats):
    return {"events": 100_000, "window_s": 10.0, "setup_s": 1.0,
            "stats": stats, "kernel_shapes": {}, "device": None}


def _read(name, rec):
    return run.reader(name, ROOT)(rec)


def test_readers():
    rec = _rec(**STATS)
    assert _read(NEW[0], rec) == pytest.approx(5.0)
    assert _read(NEW[1], rec) == pytest.approx(25.0)
    assert _read(NEW[2], rec) == pytest.approx(40.0)
    # nothing shared, no event in the window
    assert _read(NEW[1], _rec(**dict(STATS, shared_rows=0))) is None
    assert _read(NEW[0], dict(rec, events=0)) is None
    assert _read(NEW[2], dict(rec, events=0)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_program_without_the_field(name):
    """The parent of the change that counts them: no reading, no error."""
    assert _read(name, _rec(plan_s=1.0, bursts=10, shared_bursts=5)) is None


def test_the_cell_is_found_by_name():
    spec = run.load_cell(CELL, ROOT)
    assert spec["cfg"]["name"] == "stock-trends"
    assert spec["cfg"]["pattern"] == "seq_kleene_edge"
    assert spec["mix"]["driver"] == "replay"
    assert spec["cell"]["chips"] == 1
    assert {m["name"] for m in spec["end_to_end"]} == {"events_per_s",
                                                       "setup_s"}
    layer = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert (layer[name]["layer"], layer[name]["moves"]) == \
            ("plan", "events_per_s")
        assert layer[name]["workloads"] == [CELL]
    assert "masked_propagate_roofline" in layer
    assert "dense_propagate_roofline" not in layer
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (cfg,) = [c for c in bench["configs"] if c["name"] == "stock-trends"]
    assert cfg["reduced"] == spec["cfg"]["reduced"] == ["stream_minutes"]


@pytest.mark.parametrize("seed", [7, 2**33 + 1])
def test_float32_control_fails_the_limit(seed):
    """Two companies of the cell's density, two stream-minutes: float32
    loses windows to overflow, float64 holds them."""
    spec = run.load_cell(CELL, ROOT)
    cfg, limit = spec["cfg"], spec["mix"]["limits"]["max_rel_gap"]
    s = streamgen.district_stream(
        seed=seed, segment=0, minutes=2,
        events_per_minute=2 * cfg["events_per_group_minute"], districts=2,
        n_types=2, type_weights=cfg["type_weights"],
        burstiness=cfg["burstiness"], n_attrs=len(cfg["schema"]["attrs"]))
    r = control.reading(cfg, limit, s, list(range(0, 61, 15)))
    assert r["gap"] > limit and r["over_limit"] > 0
    assert r["values_lost_to_float32"] > 0
    assert r["gap_where_float32_finite"] > limit


def test_a_traced_cpu_run_reports_the_cell(tiny_root, monkeypatch):
    monkeypatch.setattr(drivers, "_trace", lambda ctx, obs: None)
    out = run.run_cell(CELL, 2**31 + 3, 0.5, True, backend="torch",
                       device="cpu", root=tiny_root)
    assert out["correct"]
    got = out["metrics"]
    for name in NEW:
        assert got[name]["value"] > 0, name
    assert 0 < got["event_snapshot_pct.replay"]["value"] < 100
    spec = run.load_cell(CELL, tiny_root)
    # all but the readers of the device trace, which the CPU run lacks
    want = {m["name"] for m in spec["per_layer"]
            if m["source"] != "device_trace"}
    assert want <= set(got)
    assert np.isfinite([v["value"] for v in got.values()]).all()
