"""The long-burst cell, ``ridesharing-long-bursts.replay``: it is found by
name with its configuration, mix and metrics, and its configuration is
ridesharing-w1's but for the burstiness and the density; the reference
holds a long-burst window past 2^512 to exact integers; its four readers
(the share of Kleene rows in long bursts, of windows past 2^512, of the
bytes to the card that are masks, of the solved cells in problems past 256
rows) read what they should and nothing where there is nothing; only this
configuration's stream has bursts past 256 rows, not ridesharing-w1's;
the float32 control fails its limit; a run whose answers
are altered reads as not correct at the configuration's own density; and
a traced run on the CPU reports every per-layer metric the cell lists but
the device trace's."""

import json
import math

import numpy as np
import pytest
from conftest import ROOT, tiny_copy

from hbench import control, drivers, run, streamgen
from hbench.references import seq_kleene as ref

CELL = "ridesharing-long-bursts.replay"
NEW = ("long_burst_pct.replay", "large_count_pct.replay",
       "mask_h2d_pct.replay", "wide_propagate_pct.replay")
REPLAY = ["ridesharing-w1.replay", "smarthome-w1.replay",
          "stock-trends.replay", "ridesharing-trips.replay", CELL]
STATS = {"kleene_rows": 8_000, "long_kleene_rows": 7_600,
         "large_count_windows": 52, "windows_emitted": 2_600,
         "execute_mask_bytes": 3_000_000, "execute_h2d_bytes": 3_200_000,
         "wide_propagate_cells": 1_000, "propagate_cells": 50_000}


def _cfg(name):
    return json.loads((ROOT / "hbench" / "configs" / f"{name}.json")
                      .read_text())


CFG = _cfg("ridesharing-long-bursts")


@pytest.fixture(scope="module")
def long_root(tmp_path_factory):
    """The tiny copy with this configuration at its own density: at the
    tiny copy's 200 events a district-minute a district keeps one type for
    minutes, and most segments hold no trend."""
    root = tiny_copy(tmp_path_factory.mktemp("long_bursts"))
    f = root / "hbench" / "configs" / "ridesharing-long-bursts.json"
    cfg = json.loads(f.read_text())
    cfg["events_per_group_minute"] = CFG["events_per_group_minute"]
    f.write_text(json.dumps(cfg))
    return root


def _rec(**stats):
    return {"events": 100_000, "window_s": 10.0, "setup_s": 1.0,
            "stats": stats, "kernel_shapes": {}, "device": None}


def _read(name, rec):
    return run.reader(name, ROOT)(rec)


def test_readers():
    rec = _rec(**STATS)
    assert _read(NEW[0], rec) == pytest.approx(95.0)
    assert _read(NEW[1], rec) == pytest.approx(2.0)
    assert _read(NEW[2], rec) == pytest.approx(93.75)
    assert _read(NEW[3], rec) == pytest.approx(2.0)
    # no Kleene burst planned, no window emitted, nothing to the card
    assert _read(NEW[0], _rec(**dict(STATS, kleene_rows=0))) is None
    assert _read(NEW[1], _rec(**dict(STATS, windows_emitted=0))) is None
    assert _read(NEW[2], _rec(**dict(STATS, execute_h2d_bytes=0))) is None
    assert _read(NEW[3], _rec(**dict(STATS, propagate_cells=0))) is None
    # a cell without masks or without large counts reads 0
    assert _read(NEW[1], _rec(**dict(STATS, large_count_windows=0))) == 0
    assert _read(NEW[2], _rec(**dict(STATS, execute_mask_bytes=0))) == 0
    assert _read(NEW[3], _rec(**dict(STATS, wide_propagate_cells=0))) == 0


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_program_without_the_field(name):
    """The parent of the change that counts them: no reading, no error."""
    rec = _rec(bursts=10, windows_emitted=2_600,
               execute_h2d_bytes=3_200_000, propagate_cells=50_000)
    assert _read(name, rec) is None


def test_the_cell_is_found_by_name():
    spec = run.load_cell(CELL, ROOT)
    cfg = spec["cfg"]
    assert cfg["name"] == "ridesharing-long-bursts"
    assert cfg["pattern"] == "seq_kleene"
    assert (cfg["burstiness"], cfg["events_per_group_minute"]) == \
        (0.998, 900)
    assert spec["mix"] == {"driver": "replay", "districts": 16,
                           "micro_batch": 16,
                           "limits": {"max_rel_gap": 1e-10,
                                      "missing_windows": 0,
                                      "extra_windows": 0}}
    assert spec["cell"]["chips"] == 1
    # a 240-tick segment of 16 districts: ~57,600 events
    assert drivers.segment_ticks(cfg, spec["mix"]) == 240
    assert {m["name"] for m in spec["end_to_end"]} == {"events_per_s",
                                                       "setup_s"}
    layer = {m["name"]: m for m in spec["per_layer"]}
    # a share that only a fault in the program lowers reads better higher
    want = {"long_burst_pct.replay": ("plan", "higher"),
            "large_count_pct.replay": ("fold", "higher"),
            "mask_h2d_pct.replay": ("execute", "lower"),
            "wide_propagate_pct.replay": ("kernels", "higher")}
    for name, (lay, better) in want.items():
        assert (layer[name]["layer"], layer[name]["moves"],
                layer[name]["unit"], layer[name]["better"]) == \
            (lay, "events_per_s", "%", better)
        assert set(REPLAY) <= set(layer[name]["workloads"])
    # every per-layer metric of ridesharing-w1's replay cell, and the
    # share of shared rows that carry an event-level snapshot
    w1 = {m["name"] for m in run.load_cell("ridesharing-w1.replay",
                                           ROOT)["per_layer"]}
    assert w1 <= set(layer)
    assert {"masked_propagate_roofline", "dense_propagate_roofline",
            "device_idle_pct.replay", "event_snapshot_pct.replay"} <= \
        set(layer)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (c,) = [c for c in bench["configs"]
            if c["name"] == "ridesharing-long-bursts"]
    assert c["reduced"] == cfg["reduced"] == ["stream_minutes"]
    assert c["file"] == "hbench/configs/ridesharing-long-bursts.json"
    assert len(c["source"]) <= 200


def test_configuration_is_ridesharing_w1_but_its_bursts():
    w1 = _cfg("ridesharing-w1")
    differ = {k for k in set(w1) | set(CFG) if w1.get(k) != CFG.get(k)}
    assert differ == {"name", "deployment", "burstiness",
                      "events_per_group_minute", "assumed"}
    assert all(a in " ".join(CFG["assumed"])
               for a in ("burstiness 0.998", "events_per_group_minute 900"))


def _travel_runs(name, seed, segment):
    """The lengths of the Travel bursts (a district's run of Travels
    inside one 15-tick pane) of one segment of the cell of ``name``."""
    cfg = _cfg(name)
    mix = run.load_cell(f"{name}.replay", ROOT)["mix"]
    t_end = drivers.segment_ticks(cfg, mix)
    s = drivers.cell_stream(cfg, mix, seed, segment, t_end / 60)
    key = s.group * t_end + s.time // 15
    o = np.lexsort((np.arange(len(key)), key))
    k, t = key[o], s.type_id[o]
    first = np.concatenate([[0], np.nonzero(
        (np.diff(k) != 0) | (np.diff(t) != 0))[0] + 1])
    runs = np.diff(np.concatenate([first, [len(t)]]))
    return runs[t[first] == cfg["schema"]["types"].index("Travel")]


@pytest.mark.parametrize("seed", [5, 2**32 + 9])
def test_only_this_cell_has_bursts_past_256_rows(seed):
    """The regime ``wide_propagate_pct.replay`` reads: Travel bursts past
    256 rows (the dense kernel's fifth scan round, the masked kernel's
    wrapping copy rings) in every segment of this cell's stream, and in
    none of ridesharing-w1's, whose longest bursts stay under 200."""
    for segment in range(3):
        w1 = _travel_runs("ridesharing-w1", seed, segment)
        long = _travel_runs("ridesharing-long-bursts", seed, segment)
        assert w1.max() < 200
        assert long.max() > 256
        assert 0 < long[long > 256].sum() < 0.1 * long.sum()


def _long_stream(seed, districts=2, minutes=2):
    return streamgen.district_stream(
        seed=seed, segment=0, minutes=minutes,
        events_per_minute=districts * CFG["events_per_group_minute"],
        districts=districts, n_types=len(CFG["schema"]["types"]),
        type_weights=CFG["type_weights"], burstiness=CFG["burstiness"],
        n_attrs=len(CFG["schema"]["attrs"]))


def _exact_count(cfg, q, t, at):
    """COUNT(*) of one window in Python integers: sum over matched heads
    of 2^m - 1, m the matched Kleene events after the head."""
    h = ref._matches(cfg, q, "head", t, at)
    k = ref._matches(cfg, q, "kleene", t, at).astype(np.int64)
    after = np.cumsum(k[::-1])[::-1] - k
    return sum((1 << int(m)) - 1 for m in after[h])


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_evaluate_holds_a_window_past_2_512_to_exact_integers(seed):
    """The district-window with the largest count of four long-burst
    districts over four minutes (one in eight passes 2^512): ``evaluate``
    and ``window_direct`` against the exact integer, rounded once to
    float64."""
    s = _long_stream(seed, districts=4, minutes=4)
    starts = list(range(0, 240 - 60 + 1, 15))
    out = ref.evaluate(CFG, s.type_id, s.time, s.attrs, s.group, starts,
                       [0, 1, 2, 3])
    key = max(out, key=lambda k: out[k]["COUNT(*)"])
    qn, g, w0 = key
    q = next(q for q in CFG["queries"] if q["name"] == qn)
    sel = (s.group == g) & (s.time >= w0) & (s.time < w0 + 60)
    exact = _exact_count(CFG, q, s.type_id[sel], s.attrs[sel])
    assert exact >= 1 << 512
    assert math.isfinite(float(exact))
    direct = ref.window_direct(CFG, q, s.type_id[sel], s.attrs[sel])
    assert direct["COUNT(*)"] == float(exact)
    assert out[key]["COUNT(*)"] == pytest.approx(float(exact), rel=1e-15)
    # the Travel bursts of the window: one of 128 events or more
    t = s.type_id[sel]
    cut = np.nonzero(np.diff(t))[0] + 1
    runs = np.diff(np.concatenate([[0], cut, [len(t)]]))
    first = np.concatenate([[0], cut])
    travel = CFG["schema"]["types"].index("Travel")
    assert runs[t[first] == travel].max() >= 128


@pytest.mark.parametrize("seed", [7, 2**33 + 1])
def test_float32_control_fails_the_limit(seed):
    """Two districts of the cell's density, two stream-minutes: float32
    loses every count past 2^128 to overflow, float64 holds them."""
    limit = run.load_cell(CELL, ROOT)["mix"]["limits"]["max_rel_gap"]
    r = control.reading(CFG, limit, _long_stream(seed),
                        list(range(0, 61, 15)))
    assert r["gap"] > limit and r["over_limit"] > 0
    assert r["values_lost_to_float32"] > 0


def _answer_altered(mp):
    """One window in 97 with trends has its COUNT(*) moved by a part in
    10^7 where it is emitted (``test_hbench_faults.py``'s fault)."""
    from repro_torch.core.engine import HamletRuntime

    emit = HamletRuntime._emit
    seen = [0]

    def altered(self, *a, **k):
        vals = emit(self, *a, **k)
        if vals.get("COUNT(*)", 0) > 0:
            seen[0] += 1
            if seen[0] % 97 == 0:
                vals["COUNT(*)"] *= 1 + 1e-7
        return vals

    mp.setattr(HamletRuntime, "_emit", altered)


def test_altered_answer_reads_not_correct_at_the_cells_density(
        long_root, monkeypatch):
    """At 900 events a district-minute the warm-up segment and the first
    measured one, which every run checks, hold 100 windows with trends
    for this seed, so the 97th is altered however few segments the run
    completes."""
    _answer_altered(monkeypatch)
    out = run.run_cell(CELL, 2**31 + 5, 1.0, False, backend="torch",
                       device="cpu", root=long_root)
    assert not out["correct"]
    assert out["failed"] > 0


def test_a_traced_cpu_run_reports_the_cell(long_root, monkeypatch):
    monkeypatch.setattr(drivers, "_trace", lambda ctx, obs: None)
    out = run.run_cell(CELL, 2**31 + 3, 0.5, True, backend="torch",
                       device="cpu", root=long_root)
    assert out["correct"]
    got = out["metrics"]
    assert got["long_burst_pct.replay"]["value"] >= 90
    assert got["mask_h2d_pct.replay"]["value"] > 50
    assert got["large_count_pct.replay"]["value"] >= 0
    assert got["wide_propagate_pct.replay"]["value"] >= 0
    spec = run.load_cell(CELL, long_root)
    # all but the readers of the device trace, which the CPU run lacks
    want = {m["name"] for m in spec["per_layer"]
            if m["source"] != "device_trace"}
    assert want <= set(got)
    assert np.isfinite([v["value"] for v in got.values()]).all()
