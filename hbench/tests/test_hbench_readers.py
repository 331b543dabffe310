"""Each metric reader on a hand-made record: what it reads, and that it
returns nothing where there is nothing to read (never 0 for a share of a
roofline)."""

import math

import pytest
from conftest import ROOT

from hbench import roofline
from hbench.run import reader

STATS = {"plan_s": 2.0, "execute_s": 0.5, "finalize_s": 0.25, "fold_s": 0.1,
         "bursts": 400, "shared_bursts": 100}
SHAPES = {"masked_propagate": {(78, 313, 2, "float64"): 10},
          "dense_propagate": {(485, 512, 2, "float64"): 4}}


def _rec(**kw):
    rec = {"events": 100_000, "window_s": 10.0, "setup_s": 12.5,
           "stats": STATS, "kernel_shapes": SHAPES, "device": None}
    rec.update(kw)
    return rec


def _read(name, rec):
    return reader(name, ROOT)(rec)


def test_rates_and_phases():
    rec = _rec()
    assert _read("events_per_s", rec) == 10_000
    assert _read("setup_s", rec) == 12.5
    assert _read("plan_us_per_event.replay", rec) == pytest.approx(20.0)
    assert _read("execute_us_per_event.replay", rec) == pytest.approx(5.0)
    assert _read("finalize_us_per_event.replay", rec) == pytest.approx(2.5)
    assert _read("fold_us_per_event.replay", rec) == pytest.approx(1.0)
    assert _read("shared_burst_pct.replay", rec) == 25.0
    assert _read("shared_burst_pct.replay",
                 _rec(stats=dict(STATS, bursts=0))) is None


def test_latency_tails_over_all_results():
    lat = list(range(1, 101))
    rec = _rec(latency_ms=lat, pane_proc_ms=lat, offer_lag_ms=lat)
    assert _read("latency_p50_ms", rec) == 50.5
    assert _read("latency_p95_ms.open", rec) == pytest.approx(95.05)
    assert _read("pane_proc_ms_p95.open", rec) == pytest.approx(95.05)
    assert _read("offer_lag_ms_p95.open", rec) == pytest.approx(95.05)
    assert _read("latency_p95_ms.open", _rec(latency_ms=[])) is None


@pytest.mark.parametrize("kernel", ["masked_propagate", "dense_propagate"])
def test_roofline_share(kernel):
    bound = roofline.shapes_bound_s(kernel, SHAPES[kernel])
    dev = {"busy_s": 0.5, "window_s": 10.0,
           "device_ops": {f"void {kernel}_kernel<double>(...)": 4 * bound,
                          "Memcpy HtoD": 1.0}}
    assert _read(f"{kernel}_roofline", _rec(device=dev)) == \
        pytest.approx(25.0)
    # nothing launched, or no trace: no reading at all
    assert _read(f"{kernel}_roofline", _rec()) is None
    assert _read(f"{kernel}_roofline", _rec(
        device=dev, kernel_shapes=dict(SHAPES, **{kernel: {}}))) is None


def test_roofline_work_formulas():
    nbytes, ops = roofline.masked_propagate_work(78, 313, 2)
    tri = 78 * 313 * 312 / 2
    assert nbytes == 8 * (2 * 78 * 313 * 2 + tri) and ops == 4 * tri
    nbytes, ops = roofline.dense_propagate_work(485, 512, 2)
    assert nbytes == 16 * 485 * 512 * 2 and ops == 3 * 485 * 512 * 2
    assert math.isclose(roofline.bound_s(3.35e12, 0, "float64"), 1.0)


@pytest.mark.parametrize("name", ["device_idle_pct.replay",
                                  "device_idle_pct.open"])
def test_idle_share(name):
    dev = {"busy_s": 0.25, "window_s": 10.0, "device_ops": {}}
    assert _read(name, _rec(device=dev)) == pytest.approx(97.5)
    assert _read(name, _rec()) is None


def test_idle_gaps_named_by_the_host_phase_spans():
    """A gap of the card is charged to the phase spans that cover it, on
    the profiler's clock, and the rest of it to ``other``."""
    from types import SimpleNamespace

    from hbench.devtrace import MARK, DeviceTrace

    # tracer origin at perf_counter 100.0 s; the start mark at 100.5 s
    # (ts 500,000 us), which the profiler read as 7e9 ns
    evs = [{"name": f"{MARK}.start", "ph": "i", "ts": 500_000.0},
           {"name": "plan", "ph": "X", "cat": "phase", "ts": 501_000.0,
            "dur": 3_000.0},
           {"name": "fold", "ph": "X", "cat": "phase", "ts": 503_500.0,
            "dur": 2_000.0}]
    tr = DeviceTrace(SimpleNamespace(
        tracer=SimpleNamespace(events=lambda: evs)))
    tr._obs_at["start"], tr._t0 = 100.5, 100.5
    ms = 1_000_000
    got = tr._attribute([(7e9, 7e9 + 2 * ms), (7e9 + 3 * ms, 7e9 + 6 * ms)],
                        int(7e9))
    # plan covers 1-4 ms, fold 4-5.5 ms (its overlap with plan cut away)
    assert got == pytest.approx({"other": 0.0015, "plan": 0.002,
                                 "fold": 0.0015})
