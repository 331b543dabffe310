"""The long-burst ridesharing deployment
(``hbench/configs/ridesharing-long-bursts.json``): ridesharing-w1's 25
queries ``SEQ(head, Travel+)`` over a stream whose Travel bursts run to
~220 events, so that window counts pass 2^512.

* ``HamletRuntime`` against the benchmark's plain reference
  (``hbench/references/seq_kleene.py``, loaded by file path) and the JAX
  package's runtime on the numpy and PyTorch backends on the CPU at K in
  {1, 16}: a copy of the configuration cut to two districts and 30-tick
  windows, bursts of 100 events and more, counts under 2^512; a burst of
  300 rows, past ``WIDE_ROWS``; and on ``cuda`` where a card is, on
  windows past 2^512 and on the 300-row burst;
* the counters ``kleene_rows``, ``long_kleene_rows``,
  ``large_count_windows``, ``wide_propagate_cells`` and
  ``execute_mask_bytes`` on hand-built streams with known bursts and one
  window past 2^512, in ``HamletRuntime`` and in the streaming layer's
  ``OverloadRuntime``.
"""

import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.engine import HamletRuntime as RefRuntime
from repro.core.events import EventBatch as RefBatch
from repro.core.events import StreamSchema as RefSchema
from repro.core.pattern import EventType as RefType
from repro.core.pattern import Kleene as RefKleene
from repro.core.pattern import Seq as RefSeq
from repro.core.query import Pred as RefPred
from repro.core.query import Query as RefQuery
from repro.core.query import Workload as RefWorkload
from repro.core.query import count_star as ref_count_star
from repro_torch.core.batch_exec import PaneBatchExecutor
from repro_torch.core.engine import (LARGE_COUNT, LONG_BURST, WIDE_ROWS,
                                     HamletRuntime, _Instance)
from repro_torch.core.events import EventBatch
from repro_torch.core.optimizer import DynamicPolicy
from repro_torch.kernels import ops
from repro_torch.obs import Observability
from repro_torch.overload import OverloadConfig, OverloadRuntime

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str):
    """A module of the benchmark, by file path (its absolute imports of
    ``hbench`` resolve from the repository's root)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "long_bursts_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("hbench/references/seq_kleene.py")
queries = _load("hbench/queries/seq_kleene.py")
streamgen = _load("hbench/streamgen.py")

CFG = json.loads((ROOT / "hbench" / "configs"
                  / "ridesharing-long-bursts.json").read_text())
TYPES = CFG["schema"]["types"]
REQUEST, ACCEPT, TRAVEL = (TYPES.index(t)
                           for t in ("Request", "Accept", "Travel"))
SPEED = CFG["schema"]["attrs"].index("speed")
T_END = 240


def _stream(cfg, seed, districts=2):
    return streamgen.district_stream(
        seed=seed, segment=0, minutes=T_END / 60,
        events_per_minute=districts * cfg["events_per_group_minute"],
        districts=districts, n_types=len(TYPES),
        type_weights=cfg["type_weights"], burstiness=cfg["burstiness"],
        n_attrs=len(cfg["schema"]["attrs"]),
        attr_range=tuple(cfg["attr_range"]))


def _batch(wl, s):
    return EventBatch(wl.schema, s.type_id, s.time, s.attrs, s.group)


def _runtime(wl, backend, K, obs=None):
    return HamletRuntime(wl, policy=DynamicPolicy(), backend=backend,
                         device=None if backend == "np" else
                         ("cuda:0" if backend == "cuda" else "cpu"),
                         micro_batch=K, obs=obs)


def _held(got, want, rel):
    """Every window of ``want`` in ``got``, and no other: COUNT held
    exactly below 2^53 and to ``rel`` above it.  Returns the largest count
    and how many were held exactly."""
    assert got.keys() == want.keys()
    top = exact = 0
    for key, vals in want.items():
        v, g = vals["COUNT(*)"], got[key]["COUNT(*)"]
        assert math.isfinite(v)
        top = max(top, v)
        if v < 2**53:
            assert g == v, (key, g, v)
            exact += 1
        else:
            assert g == pytest.approx(v, rel=rel), (key, g, v)
    return top, exact


def _against_reference(cfg, wl, rt, s, rel, t_end=T_END):
    """Every window of the run against the reference (see ``_held``)."""
    got = rt.run(_batch(wl, s), t_end)
    starts = list(range(0, t_end - cfg["within"] + 1, cfg["slide"]))
    want = ref.evaluate(cfg, s.type_id, s.time, s.attrs, s.group, starts,
                        np.unique(s.group).tolist())
    return _held(got, want, rel)


def _jax_run(cfg, s, t_end=T_END):
    """The JAX package's runtime on the same queries and stream, its
    results keyed as the port's."""
    schema = RefSchema(types=tuple(cfg["schema"]["types"]),
                       attrs=tuple(cfg["schema"]["attrs"]))
    qs = []
    for q in cfg["queries"]:
        assert q["aggs"] == ["COUNT(*)"], q["name"]
        preds: dict = {}
        for p in q["preds"]:
            preds.setdefault(p["type"], []).append(
                RefPred(p["attr"], p["op"], float(p["value"])))
        qs.append(RefQuery(
            q["name"], RefSeq(RefType(q["head"]), RefKleene(RefType(
                q["kleene"]))), aggs=(ref_count_star(),),
            preds=preds or None, within=int(cfg["within"]),
            slide=int(cfg["slide"])))
    return RefRuntime(RefWorkload(schema, qs), micro_batch=16).run(
        RefBatch(schema, s.type_id, s.time, s.attrs, s.group), t_end)


# 30-tick windows keep every count of two districts at 900 events a minute
# under 2^512, with Travel bursts of ~220 events
SMALL = dict(CFG, within=30)


SMALL_SEED = 2**31 + 11


@pytest.fixture(scope="module")
def jax_small():
    """The JAX package's results on the small copy's stream."""
    return _jax_run(SMALL, _stream(SMALL, SMALL_SEED))


@pytest.mark.parametrize("K", [1, 16])
@pytest.mark.parametrize("backend", ["np", "torch"])
def test_runtime_matches_reference_in_long_bursts(backend, K, jax_small):
    wl = queries.workload(SMALL)
    s = _stream(SMALL, SMALL_SEED)
    rt = _runtime(wl, backend, K)
    top, exact = _against_reference(SMALL, wl, rt, s, 1e-14)
    assert exact > 0 and 2.0**300 < top < LARGE_COUNT
    # bursts of 100 events and more: most Kleene rows lie in long ones
    assert rt.stats.long_kleene_rows > 0.8 * rt.stats.kleene_rows
    assert rt.stats.large_count_windows == 0
    # the JAX package on the same stream: every window, COUNT exact
    # below 2^53 (all counts lie under 2^512, where its doubling is exact)
    again = _runtime(wl, backend, K).run(_batch(wl, s), T_END)
    assert _held(again, jax_small, 1e-14)[1] == exact


def test_runtime_matches_reference_past_2_512_on_cuda():
    """The full configuration (60-tick windows, counts to ~2^900) on the
    card: the masked kernel's row loop and the finalize on the device keep
    every window finite and within the cell's limit of the reference."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the propagation kernels run on the "
                    "card")
    wl = queries.workload(CFG)
    rt = _runtime(wl, "cuda", 16)
    top, _ = _against_reference(CFG, wl, rt, _stream(CFG, 2**31 + 11),
                                1e-12)
    assert top >= LARGE_COUNT
    assert rt.stats.large_count_windows > 0
    top, _ = _against_reference(CFG, wl, _runtime(wl, "cuda", 1),
                                _hand_built(), 1e-12)
    assert top >= 2.0**519
    # a burst of 300 rows: the dense kernel's fifth scan round and the
    # masked kernel's wrapping copy rings
    for K in (1, 16):
        rt = _runtime(wl, "cuda", K)
        _against_reference(CFG, wl, rt, _wide(), 1e-12, t_end=60)
        assert rt.stats.wide_propagate_cells > 0


# ------------------------------------------------------- the counters


def _hand_built():
    """One district over one 60-tick window: a Request, then 130 Travels in
    each of the first three 15-tick panes and, in the fourth, 60 Travels,
    an Accept and 70 Travels.  Kleene bursts of 130, 130, 130, 60 and 70
    rows; 520 Travels after the Request, so COUNT(*) is 2^520 - 1 for the
    Request queries whose Travels all match.  Travel speeds cycle over
    0.5 .. 9.5, so the speed predicates give masked groups."""
    parts = [(REQUEST, 0, 1)]
    for pane in range(3):
        parts.append((TRAVEL, pane, 130))
    parts += [(TRAVEL, 3, 60), (ACCEPT, 3, 1), (TRAVEL, 3, 70)]
    return _parts_stream(parts)


def _wide():
    """One district over one 60-tick window: a Request and 40 Travels,
    then one burst of 300 Travels, then an Accept and 100 Travels, then 50
    Travels.  490 Travels after the Request keep every count under
    2^512; the 300-row burst is past ``WIDE_ROWS``."""
    return _parts_stream([(REQUEST, 0, 1), (TRAVEL, 0, 40), (TRAVEL, 1, 300),
                          (ACCEPT, 2, 1), (TRAVEL, 2, 100), (TRAVEL, 3, 50)])


def _parts_stream(parts):
    """``(type, pane, count)`` runs in order, spread over each 15-tick
    pane, in district 0; Travel speeds cycle over 0.5 .. 9.5."""
    tid, tm = [], []
    for pane in range(4):
        n = sum(c for _, p, c in parts if p == pane)
        ticks = pane * 15 + np.arange(n) * 15 // n
        k = 0
        for t, p, c in parts:
            if p == pane:
                tid += [t] * c
                tm += ticks[k:k + c].tolist()
                k += c
    at = np.full((len(tid), len(CFG["schema"]["attrs"])), 5.0)
    at[:, SPEED] = np.arange(len(tid)) % 10 + 0.5
    return streamgen.Stream(np.array(tid, np.int32), np.array(tm, np.int64),
                            at, np.zeros(len(tid), np.int64))


# Request queries without a speed predicate: their window passes 2^512
BIG = sum(q["head"] == "Request" and not q["preds"] for q in CFG["queries"])


def test_hand_built_stream_has_the_bursts_it_says():
    s = _hand_built()
    assert BIG == 3
    starts = [0]
    want = ref.evaluate(CFG, s.type_id, s.time, s.attrs, s.group, starts,
                        [0])
    big = [k for k, v in want.items() if v["COUNT(*)"] >= LARGE_COUNT]
    assert len(big) == BIG and len(want) == len(CFG["queries"])
    assert all(v["COUNT(*)"] == 2.0**520 for k, v in want.items()
               if k in big)


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("backend", ["np", "torch"])
def test_burst_and_count_counters_without_observability(backend, K):
    """Counted with no ``Observability``, once a burst (not once a query),
    alike at any K and on both backends; a stream run twice counts twice
    what it counts once."""
    wl = queries.workload(CFG)
    rt = _runtime(wl, backend, K)
    got = rt.run(_batch(wl, _hand_built()), 60)
    s = rt.stats
    assert s.kleene_rows == 3 * 130 + 60 + 70
    assert s.long_kleene_rows == 3 * 130
    assert LONG_BURST == 128
    assert s.windows_emitted == len(got) == len(CFG["queries"])
    assert s.large_count_windows == BIG
    assert sum(v["COUNT(*)"] >= LARGE_COUNT for v in got.values()) == BIG
    assert s.execute_mask_bytes == s.execute_h2d_bytes == 0
    assert s.wide_propagate_cells == 0 < s.propagate_cells
    rt.run(_batch(wl, _hand_built()), 60)
    assert (s.kleene_rows, s.long_kleene_rows, s.large_count_windows) == \
        (2 * 520, 2 * 390, 2 * BIG)


def test_large_count_windows_reads_the_largest_finite_value():
    """``_emit`` counts a window whose result holds a finite value of
    2^512 or more: not one below it, nor an overflowed or undefined one."""
    wl = queries.workload(CFG)
    rt = _runtime(wl, "np", 1)
    ctx, aqi = rt.ctxs[0], rt.components[0][0]
    q = wl.atomic[aqi]
    at = ctx.layout.rp_idx(("count",))
    counted = []
    for v in (2.0**512, 2.0**511, math.inf, math.nan, 2.0**1000, 0.0):
        u = ctx.layout.fresh_state()
        u[at] = v
        before = rt.stats.large_count_windows
        vals = rt._emit(ctx, 0, q, _Instance(0, u), 0)
        assert vals["COUNT(*)"] == v or math.isnan(v)
        counted.append(rt.stats.large_count_windows - before)
    assert counted == [1, 0, 0, 0, 1, 0]


@pytest.mark.parametrize("K", [1, 16])
@pytest.mark.parametrize("backend", ["np", "torch"])
def test_wide_problems_are_counted(monkeypatch, backend, K):
    """``wide_propagate_cells`` is the cells (rows x basis columns) of
    every problem of more than ``WIDE_ROWS`` rows handed to the executor,
    and the 300-row burst's windows are held by the reference and by the
    JAX package."""
    seen = [0]
    submit = PaneBatchExecutor.submit

    def counted(self, base, mask=None):
        if base.shape[0] > WIDE_ROWS:
            seen[0] += base.size
        return submit(self, base, mask)

    monkeypatch.setattr(PaneBatchExecutor, "submit", counted)
    wl = queries.workload(CFG)
    rt = _runtime(wl, backend, K)
    s = _wide()
    top, exact = _against_reference(CFG, wl, rt, s, 1e-14, t_end=60)
    assert exact > 0 and 2.0**400 < top < LARGE_COUNT
    st = rt.stats
    assert st.wide_propagate_cells == seen[0] > 0
    assert st.wide_propagate_cells < st.propagate_cells
    assert WIDE_ROWS == 256
    again = _runtime(wl, backend, K).run(_batch(wl, s), 60)
    _held(again, _jax_run(CFG, s, t_end=60), 1e-14)


@pytest.mark.parametrize("K", [1, 16])
def test_mask_bytes_are_the_masks_handed_to_the_kernel(monkeypatch, K):
    """With an ``Observability`` on a device backend, ``execute_mask_bytes``
    is every mask the masked propagation is handed, in the base's dtype,
    and the rest of ``execute_h2d_bytes`` the bases."""
    seen = {"mask": 0, "base": 0}
    masked, dense = ops.propagate_batched, ops.propagate_dense_batched

    def counted(base, mask, **k):
        seen["mask"] += mask.size * base.itemsize
        seen["base"] += base.nbytes
        return masked(base, mask, **k)

    def counted_dense(base, **k):
        seen["base"] += base.nbytes
        return dense(base, **k)

    monkeypatch.setattr(ops, "propagate_batched", counted)
    monkeypatch.setattr(ops, "propagate_dense_batched", counted_dense)
    wl = queries.workload(CFG)
    rt = _runtime(wl, "torch", K, obs=Observability())
    rt.run(_batch(wl, _hand_built()), 60)
    s = rt.stats
    assert s.execute_mask_bytes == seen["mask"] > 0
    assert s.execute_h2d_bytes == seen["mask"] + seen["base"]
    # one 130-row mask holds 130 * 130 float64 cells
    assert s.execute_mask_bytes >= 130 * 130 * 8


def test_streaming_layer_counts_large_windows():
    """``OverloadRuntime`` emits through its own fold loop: it counts the
    same windows past 2^512 and the same burst rows."""
    wl = queries.workload(CFG)
    ort = OverloadRuntime(
        wl, OverloadConfig(shed_policy="none", micro_batch=1,
                           queue_capacity=1 << 20, fold_exec=True,
                           pipeline_flush=False),
        policy=DynamicPolicy(), backend="np")
    s = _hand_built()
    for t in range(0, 60, ort.pane):
        lo, hi = s.ticks(t, t + ort.pane).start, s.ticks(t, t + ort.pane).stop
        assert ort.offer(EventBatch(wl.schema, s.type_id[lo:hi],
                                    s.time[lo:hi], s.attrs[lo:hi],
                                    s.group[lo:hi])) == hi - lo
        ort.step_pane()
    st = ort.rt.stats
    assert st.windows_emitted == len(CFG["queries"])
    assert st.large_count_windows == BIG
    assert (st.kleene_rows, st.long_kleene_rows) == (520, 390)
