"""The comparison that decides ``correct``: every window result the timed
path emitted against the plain reference's, value by value."""

from __future__ import annotations

import math

import numpy as np

# the nearest precision below each one a configuration may state: the
# control computes the reference in it
LOWER = {"float64": "float32"}


def rel_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Per value: ``|got - want| / |want|`` (``|got|`` where want is 0);
    0 where both are the same non-finite value (NaN and NaN, an infinity
    and itself), infinite where only one side is finite."""
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        gap = np.abs(got - want) / np.where(want == 0, 1.0, np.abs(want))
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    gap = np.where(same, 0.0, gap)
    return np.where(np.isnan(gap), np.inf, gap)


def compare(got: dict, want: dict, limit: float) -> dict:
    """``got`` and ``want``: ``{(query, district, w0): {agg: value}}``.

    Returns the numbers compared: the widest relative gap over every value
    of every window both sides have, the windows the reference has and the
    system did not emit, and the windows the system emitted that the
    reference does not have; with the windows whose widest gap passes
    ``limit``."""
    keys = [k for k in want if k in got]
    g, w, win = [], [], []
    for i, k in enumerate(keys):
        gv = got[k]
        for agg, v in want[k].items():
            w.append(v)
            g.append(gv.get(agg, math.nan))
            win.append(i)
    gaps = rel_gaps(np.asarray(g, dtype=np.float64),
                    np.asarray(w, dtype=np.float64))
    per_window = np.zeros(len(keys))
    np.maximum.at(per_window, np.asarray(win, dtype=np.int64), gaps)
    return {"max_rel_gap": float(per_window.max(initial=0.0)),
            "missing_windows": sum(1 for k in want if k not in got),
            "extra_windows": sum(1 for k in got if k not in want),
            "over_limit": int(np.sum(per_window > limit))}
