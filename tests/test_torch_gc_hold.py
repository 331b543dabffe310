"""The collector hold of a micro-batch flush (``core/gc_hold.py``).

* the cyclic collector is off inside ``PaneMicroBatcher.drain`` and back
  on after it; a caller who turned it off keeps it off; an exception
  inside a flush still restores it;
* concurrent holders (8 threads from a barrier, switching as often as the
  interpreter allows) leave it on;
* ``RunStats.gc_held_flushes`` counts the flushes the hold covered, and
  ``gc_full_collections`` the full passes while an ``Observability`` is
  attached, none after ``detach``;
* the replay runtime's results on the numpy backend are bitwise those of
  a run without the hold, on ``smarthome-w1``- and ``ridesharing-w1``-
  shaped workloads (``hbench/configs/``) at K = 1 and 16.
"""

import contextlib
import gc
import json
import struct
import sys
import threading
from pathlib import Path

import pytest

from repro_torch.core import engine, gc_hold
from repro_torch.core.engine import HamletRuntime, PaneMicroBatcher
from repro_torch.core.optimizer import DynamicPolicy
from repro_torch.obs import Observability

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hbench import drivers  # noqa: E402


@pytest.fixture(autouse=True)
def collector_state():
    """Whatever a test does to the collector, the next one finds it as
    this one did."""
    was, thresholds = gc.isenabled(), gc.get_threshold()
    gc.enable()
    yield
    (gc.enable if was else gc.disable)()
    gc.set_threshold(*thresholds)


def _case(name, districts=2, density=200):
    """Two replay segments of the configuration's shapes, each 16 panes
    long (a K = 16 segment), cut to two districts at ``density``."""
    cfg = json.loads((ROOT / "hbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["events_per_group_minute"] = density
    mix = {"districts": districts, "micro_batch": 16}
    wl = drivers._workload(cfg)
    t_end = drivers.segment_ticks(cfg, mix)
    segs = [drivers._batch(wl, drivers.cell_stream(
        cfg, mix, 2**31 + 17, i, t_end / 60)) for i in range(2)]
    return wl, segs, t_end


def _runtime(wl, K, obs=None):
    return HamletRuntime(wl, policy=DynamicPolicy(), backend="np",
                         micro_batch=K, fold_exec=True, obs=obs)


def _replay(name, K, obs=None):
    """The replay driver's loop: one runtime fed each segment in turn."""
    wl, segs, t_end = _case(name)
    rt = _runtime(wl, K, obs)
    return rt, [rt.run(b, t_end) for b in segs]


def _record_collector(monkeypatch):
    """``gc.isenabled()`` as each flush's plan step saw it."""
    seen = []
    plan = PaneMicroBatcher._plan_pending

    def spy(self, pend):
        seen.append(gc.isenabled())
        return plan(self, pend)

    monkeypatch.setattr(PaneMicroBatcher, "_plan_pending", spy)
    return seen


def test_collector_off_inside_a_drain_and_on_after(monkeypatch):
    seen = _record_collector(monkeypatch)
    rt, _ = _replay("ridesharing-w1", 4)
    assert seen and not any(seen)
    assert gc.isenabled()
    assert gc_hold._depth == 0


def test_caller_who_turned_it_off_keeps_it_off(monkeypatch):
    seen = _record_collector(monkeypatch)
    gc.disable()
    rt, _ = _replay("ridesharing-w1", 4)
    assert seen and not any(seen)
    assert not gc.isenabled()
    # the hold turned nothing off, so it covered no flush
    assert rt.stats.gc_held_flushes == 0


def test_exception_inside_a_flush_restores_it(monkeypatch):
    def boom(self, pend):
        assert not gc.isenabled()
        raise RuntimeError("plan failed")

    monkeypatch.setattr(PaneMicroBatcher, "_plan_pending", boom)
    wl, segs, t_end = _case("ridesharing-w1")
    with pytest.raises(RuntimeError, match="plan failed"):
        _runtime(wl, 4).run(segs[0], t_end)
    assert gc.isenabled()
    assert gc_hold._depth == 0


def test_concurrent_holders_leave_it_on():
    """8 threads enter and leave the hold from one barrier, switching
    every microsecond: the last one out turns the collector back on."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n, rounds = 8, 2000
    barrier = threading.Barrier(n)
    inside: list = []

    def worker():
        barrier.wait(timeout=60)
        for _ in range(rounds):
            with gc_hold.collector_held() as held:
                inside.append(held and not gc.isenabled())

    try:
        threads = [threading.Thread(target=worker) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(inside) == n * rounds and all(inside)
    assert gc.isenabled()
    assert gc_hold._depth == 0


@pytest.mark.parametrize("K", [1, 16])
def test_held_flushes_counts_flushes(monkeypatch, K):
    flushes = []
    flush = PaneMicroBatcher._flush

    def count(self, pend):
        flushes.append(len(pend))
        return flush(self, pend)

    monkeypatch.setattr(PaneMicroBatcher, "_flush", count)
    rt, _ = _replay("smarthome-w1", K)
    assert rt.stats.gc_held_flushes == len(flushes) > 0
    assert sum(flushes) == rt.stats.panes
    assert max(flushes) <= K


def test_full_collections_counted_while_attached():
    obs = Observability()
    rt, _ = _replay("ridesharing-w1", 4, obs=obs)
    n0, g0 = rt.stats.gc_full_collections, rt.stats.gc_collections
    gc.collect()
    assert rt.stats.gc_full_collections == n0 + 1
    assert rt.stats.gc_collections == g0 + 1
    obs.detach()
    gc.collect()
    assert rt.stats.gc_full_collections == n0 + 1


def _bits(results: list) -> list:
    """Every window result as the bytes of its float64s."""
    return [{k: {a: struct.pack("<d", x) for a, x in v.items()}
             for k, v in res.items()} for res in results]


@pytest.mark.parametrize("K", [1, 16])
@pytest.mark.parametrize("name", ["smarthome-w1", "ridesharing-w1"])
def test_results_bitwise_with_and_without_the_hold(monkeypatch, name, K):
    rt, held = _replay(name, K)
    assert rt.stats.gc_held_flushes > 0
    monkeypatch.setattr(engine, "collector_held",
                        lambda: contextlib.nullcontext(False))
    bare, plain = _replay(name, K)
    assert bare.stats.gc_held_flushes == 0
    assert _bits(held) == _bits(plain)
    assert sum(len(r) for r in held) > 0
