"""Find the highest offered rate an open-loop cell sustains, on the card.

    python3 hbench/sweep.py --workload ridesharing-w1.open --seed 7 \
        --seconds 10 --rates 2000 3000 4000 ...

Runs the cell's ``open`` driver once at each offered rate (events/s of wall
time; everything else from the cell's mix) in one process and prints, per
rate, the latency median and 95th percentile and how far the latency grew
from the window's first fifth of panes to its last fifth.  A system that
keeps up holds that growth near zero; above the knee the backlog, and the
latency with it, grows all through the window.  The knee goes into the
cell's mix as a number (``offered_events_per_s`` at about four fifths of
it); the benchmark's own runs never search for a rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# first: run.py holds the numerical libraries to one thread before they load
from hbench.run import Context, load_cell  # noqa: E402

import numpy as np  # noqa: E402

from hbench import drivers  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    for rate in args.rates:
        mix = dict(spec["mix"], offered_events_per_s=rate)
        ctx = Context(spec["cfg"], mix, args.seed, args.seconds, False,
                      "cuda", "cuda:0", time.perf_counter())
        run = drivers.DRIVERS[mix["driver"]](ctx)
        rec = run.record
        lat = np.asarray(rec["latency_ms"])
        n = len(lat) // 5
        growth = float(np.median(lat[-n:]) - np.median(lat[:n])) if n else 0
        row = {"offered_events_per_s": rate,
               "done_events_per_s": rec["events"] / rec["window_s"],
               "window_s": rec["window_s"],
               "latency_p50_ms": float(np.percentile(lat, 50)),
               "latency_p95_ms": float(np.percentile(lat, 95)),
               "latency_growth_ms": growth,
               "pane_proc_ms_p50": float(np.percentile(rec["pane_proc_ms"],
                                                       50)),
               "pane_proc_ms_p95": float(np.percentile(rec["pane_proc_ms"],
                                                       95)),
               "offer_lag_ms_p95": float(np.percentile(rec["offer_lag_ms"],
                                                       95)),
               "lost_events": rec["lost_events"]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
