"""``decide_eval_pct.replay``, the share of the window's sharing decisions
the policy evaluated fresh: what it reads on hand-made records, nothing
where there is nothing to read (no decision in the window, or a program
without ``RunStats.decide_evals``), its entry in ``BENCHMARK.json``, and a
traced run of each replay cell on the CPU reports it."""

import json

import pytest
from conftest import ROOT, cells

from hbench import drivers, run

NAME = "decide_eval_pct.replay"


def _rec(**stats):
    return {"events": 1000, "window_s": 1.0, "setup_s": 1.0,
            "stats": stats, "kernel_shapes": {}, "device": None}


def test_reader():
    read = run.reader(NAME, ROOT)
    assert read(_rec(decisions=400, decide_evals=100)) == pytest.approx(25.0)
    assert read(_rec(decisions=400, decide_evals=0)) == 0.0
    assert read(_rec(decisions=0, decide_evals=0)) is None
    # a program that does not count fresh evaluations
    assert read(_rec(decisions=400)) is None


def test_entry():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert (m["layer"], m["source"], m["moves"], m["unit"]) == \
        ("plan", "program_counter", "events_per_s", "%")
    assert set(m["workloads"]) == {c for c in cells()
                                   if c.endswith(".replay")}


@pytest.mark.parametrize("cell", [c for c in cells() if c.endswith(".replay")])
def test_a_traced_cpu_run_reports_it(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(drivers, "_trace", lambda ctx, obs: None)
    out = run.run_cell(cell, 11, 0.5, True, backend="torch", device="cpu",
                       root=tiny_root)
    assert out["correct"]
    assert 0 <= out["metrics"][NAME]["value"] <= 100
