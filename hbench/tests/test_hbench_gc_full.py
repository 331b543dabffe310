"""``gc_full_per_mevent.replay``, the collector's full passes per million
events of the window: what it reads on hand-made records, nothing where
there is nothing to read (no event in the window, or a program without
``RunStats.gc_full_collections``), its entry in ``BENCHMARK.json``, and a
traced run of each replay cell on the CPU reports it."""

import json

import pytest
from conftest import ROOT, cells

from hbench import drivers, run

NAME = "gc_full_per_mevent.replay"
REPLAY = [c for c in cells() if c.endswith(".replay")]


def _rec(events=250_000, **stats):
    return {"events": events, "window_s": 50.0, "setup_s": 1.0,
            "stats": stats, "kernel_shapes": {}, "device": None}


def test_reader():
    read = run.reader(NAME, ROOT)
    assert read(_rec(gc_full_collections=14)) == pytest.approx(56.0)
    assert read(_rec(gc_full_collections=0)) == 0.0
    assert read(_rec(events=0, gc_full_collections=3)) is None
    # a program that does not count full passes
    assert read(_rec(gc_s=1.5, gc_collections=300)) is None


def test_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert (m["layer"], m["source"], m["moves"], m["unit"], m["better"]) \
        == ("host runtime", "program_counter", "events_per_s",
            "passes/Mevent", "lower")
    assert sorted(m["workloads"]) == sorted(REPLAY)


@pytest.mark.parametrize("cell", REPLAY)
def test_a_traced_cpu_run_reports_it(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(drivers, "_trace", lambda ctx, obs: None)
    out = run.run_cell(cell, 2**31 + 5, 0.5, True, backend="torch",
                       device="cpu", root=tiny_root)
    assert out["correct"]
    assert out["metrics"][NAME]["value"] >= 0
