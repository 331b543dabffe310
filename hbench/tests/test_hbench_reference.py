"""The plain reference against hand-worked windows, against enumeration of
every trend, and against the port's plain PyTorch backend on the CPU."""

import itertools
import json
import math

import numpy as np
import pytest
from conftest import ROOT

from hbench import check, streamgen
from hbench.references import seq_kleene as ref

CFGS = {n: json.loads((ROOT / "hbench" / "configs" / f"{n}.json")
                      .read_text())
        for n in ("ridesharing-w1", "smarthome-w1")}
HOME = CFGS["smarthome-w1"]
WORK, LOAD = range(2)


def _q(cfg, name):
    return next(q for q in cfg["queries"] if q["name"] == name)


def _events(types, values=None):
    t = np.asarray(types, dtype=np.int32)
    at = np.zeros((len(t), len(HOME["schema"]["attrs"])))
    if values is not None:
        at[:, 0] = values
    return t, at


@pytest.mark.parametrize("query,types,values,want", [
    # one head, two Loads: 3 trends, Loads counted 4 times
    ("q0", [WORK, LOAD, LOAD], [0, 1, 2],
     {"COUNT(*)": 3, "SUM(Load.value)": 6.0, "AVG(Load.value)": 1.5}),
    # a Load before every head and a head after the last Load add nothing
    ("q0", [LOAD, WORK, LOAD, LOAD, WORK], [5, 0, 1, 2, 0],
     {"COUNT(*)": 3, "SUM(Load.value)": 6.0, "AVG(Load.value)": 1.5}),
    # two heads: 2^2 - 1 + 2^1 - 1 trends
    ("q0", [WORK, LOAD, WORK, LOAD], [0, 4, 0, 2],
     {"COUNT(*)": 4, "SUM(Load.value)": 14.0,
      "AVG(Load.value)": 14.0 / 5}),
    # no Load after the head: no trend, AVG undefined
    ("q0", [LOAD, WORK], [3, 0],
     {"COUNT(*)": 0, "SUM(Load.value)": 0.0,
      "AVG(Load.value)": math.nan}),
    # q2's head holds Work.value >= 1: the first Work starts no trend
    ("q2", [WORK, LOAD, WORK, LOAD], [0.5, 1, 1.0, 2],
     {"COUNT(*)": 1, "SUM(Load.value)": 2.0, "AVG(Load.value)": 2.0}),
])
def test_hand_worked_window(query, types, values, want):
    t, at = _events(types, values)
    got = ref.window_direct(HOME, _q(HOME, query), t, at)
    for agg, v in want.items():
        assert (math.isnan(v) and math.isnan(got[agg])) or got[agg] == v


def _enumerate(cfg, q, t, at):
    """Every trend, spelled out."""
    h = ref._matches(cfg, q, "head", t, at)
    k = ref._matches(cfg, q, "kleene", t, at)
    col = ref._value_attr(q)
    x = at[:, cfg["schema"]["attrs"].index(col)] if col else np.zeros(len(t))
    count = count_k = 0
    total = 0.0
    for a in np.nonzero(h)[0]:
        later = [j for j in range(a + 1, len(t)) if k[j]]
        for r in range(1, len(later) + 1):
            for sub in itertools.combinations(later, r):
                count += 1
                count_k += r
                total += float(sum(x[j] for j in sub))
    return {"COUNT(*)": count, "COUNT_K": count_k, "SUM": total,
            "AVG": total / count_k if count_k else math.nan}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_direct_equals_enumeration(name):
    cfg = CFGS[name]
    rng = np.random.default_rng(5)
    for _ in range(40):
        n = int(rng.integers(0, 11))
        t = rng.integers(0, len(cfg["schema"]["types"]), n).astype(np.int32)
        at = rng.uniform(0, 10, (n, len(cfg["schema"]["attrs"])))
        for q in cfg["queries"][:6]:
            got = ref.window_direct(cfg, q, t, at)
            want = _enumerate(cfg, q, t, at)
            for agg, v in got.items():
                w = want[ref.parse_agg(agg)[0]]
                assert (math.isnan(v) and math.isnan(w)) or \
                    v == pytest.approx(w, rel=1e-12)


def _stream(cfg, seed, districts=3, minutes=2, epm=1800):
    return streamgen.district_stream(
        seed=seed, segment=0, minutes=minutes, events_per_minute=epm,
        districts=districts, n_types=len(cfg["schema"]["types"]),
        type_weights=cfg["type_weights"], burstiness=cfg["burstiness"],
        n_attrs=len(cfg["schema"]["attrs"]))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_all_windows_equal_direct(name):
    cfg = CFGS[name]
    s = _stream(cfg, 2**32 + 3)
    starts = list(range(0, 120 - 60 + 1, 15))
    out = ref.evaluate(cfg, s.type_id, s.time, s.attrs, s.group, starts,
                       [0, 1, 2])
    assert len(out) == 3 * len(starts) * len(cfg["queries"])
    for (qn, g, w0), vals in out.items():
        sel = (s.group == g) & (s.time >= w0) & (s.time < w0 + 60)
        want = ref.window_direct(cfg, _q(cfg, qn), s.type_id[sel],
                                 s.attrs[sel])
        gaps = check.rel_gaps(np.array([vals[a] for a in want]),
                              np.array(list(want.values())))
        assert gaps.max() <= 1e-13, (qn, g, w0)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_reference_equals_port_torch_backend(name):
    from hbench.queries import seq_kleene as port_queries
    from repro_torch.core.engine import HamletRuntime
    from repro_torch.core.events import EventBatch
    from repro_torch.core.optimizer import DynamicPolicy

    cfg = CFGS[name]
    wl = port_queries.workload(cfg)
    s = _stream(cfg, 99, districts=2, minutes=2, epm=600)
    rt = HamletRuntime(wl, policy=DynamicPolicy(), backend="torch",
                       device="cpu", micro_batch=4)
    got = rt.run(EventBatch(wl.schema, s.type_id, s.time, s.attrs, s.group),
                 120)
    want = ref.evaluate(cfg, s.type_id, s.time, s.attrs, s.group,
                        range(0, 61, 15), [0, 1])
    c = check.compare(got, want, 1e-12)
    assert c["missing_windows"] == c["extra_windows"] == 0
    assert c["max_rel_gap"] <= 1e-12
