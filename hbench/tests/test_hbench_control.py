"""The finiteness rule and the lower-precision control, at sizes a test run
holds: each configuration's windows at its mixes' district density are
finite in float64 and pass float32's range, so the reference computed in
float32 in the program's place reads as not correct against each cell's
limit, while the float64 reference reads as correct."""

import numpy as np
import pytest
from conftest import ROOT, cells

from hbench import check, streamgen
from hbench.run import load_cell


def _cell_stream(spec, seed):
    """Two districts of the cell's mix, at its density a district."""
    cfg = spec["cfg"]
    per_district = cfg["events_per_group_minute"]
    return streamgen.district_stream(
        seed=seed, segment=0, minutes=2, events_per_minute=2 * per_district,
        districts=2, n_types=len(cfg["schema"]["types"]),
        type_weights=cfg["type_weights"], burstiness=cfg["burstiness"],
        n_attrs=len(cfg["schema"]["attrs"]))


def _evaluate(spec, s, dtype):
    from importlib import import_module

    cfg = spec["cfg"]
    ref = import_module(f"hbench.references.{cfg['pattern']}")
    return ref.evaluate(cfg, s.type_id, s.time, s.attrs, s.group,
                        range(0, 61, 15), [0, 1], dtype=dtype)


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("seed", [1, 2**31 + 11, 9_000_000_001])
def test_windows_finite_in_float64_past_float32(cell, seed):
    spec = load_cell(cell, ROOT)
    out = _evaluate(spec, _cell_stream(spec, seed), np.float64)
    counts = np.array([v["COUNT(*)"] for v in out.values()])
    assert np.isfinite(counts).all()
    assert counts.max() > np.finfo(np.float32).max


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("seed", [3, 2**31 + 12, 9_000_000_002])
def test_float32_control_fails_the_cell_limit(cell, seed):
    spec = load_cell(cell, ROOT)
    limit = spec["mix"]["limits"]["max_rel_gap"]
    s = _cell_stream(spec, seed)
    want = _evaluate(spec, s, np.float64)
    control = check.compare(_evaluate(spec, s, np.float32), want, limit)
    sound = check.compare(_evaluate(spec, s, np.float64), want, limit)
    assert control["max_rel_gap"] > limit and control["over_limit"] > 0
    assert sound["max_rel_gap"] <= limit


def test_limits_sit_between_the_readings():
    """Each cell's limit lies inside the readings PERF.md gives for it: no
    lower than the widest gap of sound runs, below float32's rounding."""
    for cell in cells():
        limit = load_cell(cell, ROOT)["mix"]["limits"]["max_rel_gap"]
        assert np.finfo(np.float64).eps * 8 < limit \
            < np.finfo(np.float32).eps / 8
