"""The lower-precision control of a cell: the plain reference computed in
the precision below the configuration's (float32 for float64), put in the
program's place, against the reference in the configuration's precision,
on the cell's own stream at its own size.

    python3 hbench/control.py --workload ridesharing-w1.replay \
        --seeds 101 102 103 --seconds 30

For a ``replay`` cell the stream is the segments a run of ``--seconds``
would replay (``--segments`` of them); for an ``open`` cell, the stream a
run offers.  Prints one JSON line a seed: the widest relative gap over
every value (the number the cell's limit holds), the widest gap among the
values float32 keeps finite, and how many values float32 loses to
overflow.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from importlib import import_module
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hbench import check, drivers, streamgen  # noqa: E402
from hbench.run import load_cell  # noqa: E402


def streams(cfg: dict, mix: dict, seed: int, seconds: float,
            segments: int) -> list:
    """``[(stream, window starts)]`` of a run of the cell."""
    w, slide = int(cfg["within"]), int(cfg["slide"])
    if mix["driver"] == "replay":
        t_end = drivers.segment_ticks(cfg, mix)
        minutes = t_end / streamgen.TICKS_PER_MINUTE
        starts = list(range(0, t_end - w + 1, slide))
        return [(drivers.cell_stream(cfg, mix, seed, i, minutes), starts)
                for i in range(segments)]
    per_tick = (cfg["events_per_group_minute"] * mix["districts"]
                / streamgen.TICKS_PER_MINUTE)
    ticks = drivers.OPEN_WARMUP_MINUTES * streamgen.TICKS_PER_MINUTE \
        + seconds * mix["offered_events_per_s"] / per_tick
    s = drivers.cell_stream(cfg, mix, seed, 0,
                            ticks / streamgen.TICKS_PER_MINUTE)
    return [(s, list(range(0, int(ticks) - w + 1, slide)))]


def reading(cfg: dict, limit: float, s, starts) -> dict:
    ref = import_module(f"hbench.references.{cfg['pattern']}")
    groups = np.unique(s.group).tolist()
    args = (cfg, s.type_id, s.time, s.attrs, s.group, starts, groups)
    want = ref.evaluate(*args, dtype=np.dtype(cfg["precision"]))
    low = ref.evaluate(*args, dtype=np.dtype(check.LOWER[cfg["precision"]]))
    c = check.compare(low, want, limit)
    w = np.array([v for d in want.values() for v in d.values()])
    g = np.array([low[k][a] for k, d in want.items() for a in d])
    fin = np.isfinite(g) & np.isfinite(w)
    gaps = check.rel_gaps(g[fin], w[fin])
    return {"gap": c["max_rel_gap"], "over_limit": c["over_limit"],
            "windows": len(want),
            "gap_where_float32_finite": float(gaps.max(initial=0.0)),
            "values_lost_to_float32": int((~np.isfinite(g)
                                           & np.isfinite(w)).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--segments", type=int, default=4)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    cfg, mix = spec["cfg"], spec["mix"]
    limit = mix["limits"]["max_rel_gap"]
    for seed in args.seeds:
        rows = [reading(cfg, limit, s, starts) for s, starts in
                streams(cfg, mix, seed, args.seconds, args.segments)]
        out = {"workload": args.workload, "seed": seed, "limit": limit,
               "gap": max(r["gap"] for r in rows),
               "windows": sum(r["windows"] for r in rows),
               "over_limit": sum(r["over_limit"] for r in rows),
               "gap_where_float32_finite": max(
                   r["gap_where_float32_finite"] for r in rows),
               "values_lost_to_float32": sum(
                   r["values_lost_to_float32"] for r in rows)}
        out["gap"] = out["gap"] if math.isfinite(out["gap"]) else "inf"
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
