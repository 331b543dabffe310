"""``stacked_graphlet_pct.replay``, the share of the window's graphlets the
plan layer's stacked pass planned: what it reads on hand-made records,
nothing where there is nothing to read (no graphlet in the window, or a
program without ``RunStats.stacked_graphlets``), its entry in
``BENCHMARK.json``, and a traced run of each replay cell on the CPU
reports it."""

import json

import pytest
from conftest import ROOT, cells

from hbench import drivers, run

NAME = "stacked_graphlet_pct.replay"
REPLAY = [c for c in cells() if c.endswith(".replay")]


def _rec(**stats):
    return {"events": 1000, "window_s": 1.0, "setup_s": 1.0,
            "stats": stats, "kernel_shapes": {}, "device": None}


def test_reader():
    read = run.reader(NAME, ROOT)
    assert read(_rec(graphlets=400, stacked_graphlets=380)) == \
        pytest.approx(95.0)
    assert read(_rec(graphlets=400, stacked_graphlets=0)) == 0.0
    assert read(_rec(graphlets=0, stacked_graphlets=0)) is None
    # a program that does not count the stacked pass's graphlets
    assert read(_rec(graphlets=400, shared_graphlets=20)) is None


def test_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert (m["layer"], m["source"], m["moves"], m["unit"], m["better"]) \
        == ("plan", "program_counter", "events_per_s", "%", "higher")
    assert sorted(m["workloads"]) == sorted(REPLAY)


@pytest.mark.parametrize("cell", REPLAY)
def test_a_traced_cpu_run_reports_it(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(drivers, "_trace", lambda ctx, obs: None)
    out = run.run_cell(cell, 2**31 + 9, 0.5, True, backend="torch",
                       device="cpu", root=tiny_root)
    assert out["correct"]
    assert 0 < out["metrics"][NAME]["value"] <= 100
