"""``div_collapsed_pct.replay`` and ``scan_flush_pct.replay``, finalize's
shares of divergent graphlets folded through a state-free ``S`` block and
of flush plans run as the scan program: what they read on hand-made
records, nothing where there is nothing to read (no divergent graphlet,
no flush, or a program without the counters), their entries in
``BENCHMARK.json``, and a traced run on the CPU of each cell they list
reports them."""

import json

import pytest
from conftest import ROOT

from hbench import drivers, run

COLLAPSED, SCAN = "div_collapsed_pct.replay", "scan_flush_pct.replay"
CELLS = ["ridesharing-w1.replay", "stock-trends.replay",
         "ridesharing-trips.replay"]
STATS = {"div_graphlets": 400, "div_collapsed": 399, "fold_flushes": 32,
         "scan_flushes": 8}


def _rec(**stats):
    return {"events": 1000, "window_s": 1.0, "setup_s": 1.0,
            "stats": stats, "kernel_shapes": {}, "device": None}


def _read(name, rec):
    return run.reader(name, ROOT)(rec)


def test_readers():
    rec = _rec(**STATS)
    assert _read(COLLAPSED, rec) == pytest.approx(99.75)
    assert _read(SCAN, rec) == pytest.approx(25.0)
    assert _read(SCAN, _rec(**dict(STATS, scan_flushes=0))) == 0.0
    # no divergent graphlet folded, no flush folded
    assert _read(COLLAPSED, _rec(**dict(STATS, div_graphlets=0,
                                        div_collapsed=0))) is None
    assert _read(SCAN, _rec(**dict(STATS, fold_flushes=0,
                                   scan_flushes=0))) is None


@pytest.mark.parametrize("name", [COLLAPSED, SCAN])
def test_reader_of_a_program_without_the_fields(name):
    """The parent of the change that counts them: no reading, no error."""
    assert _read(name, _rec(fold_rounds=100, neg_rounds=10)) is None


@pytest.mark.parametrize("name", [COLLAPSED, SCAN])
def test_entry(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert (m["layer"], m["source"], m["moves"], m["unit"], m["better"]) \
        == ("finalize", "program_counter", "events_per_s", "%", "higher")
    assert m["workloads"] == CELLS
    assert bench["per_layer"][-2:] == [
        m for m in bench["per_layer"] if m["name"] in (COLLAPSED, SCAN)]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reports_them(tiny_root, cell, monkeypatch):
    monkeypatch.setattr(drivers, "_trace", lambda ctx, obs: None)
    out = run.run_cell(cell, 2**31 + 9, 0.5, True, backend="torch",
                       device="cpu", root=tiny_root)
    assert out["correct"]
    got = out["metrics"]
    assert got[COLLAPSED]["value"] == 100.0
    assert 0 <= got[SCAN]["value"] <= 100
