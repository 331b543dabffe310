"""Hold Python's cyclic collector off while a micro-batch flush runs.

A flush (plan, execute and finalize of K panes) allocates far more
short-lived objects than the collector's young thresholds: group plans,
per-burst lists, staging.  They live until the flush ends, so young
collections inside the flush promote them to the old generation, where
they count toward the next full pass although reference counting frees
them a moment later.  Holding the collector off for the flush lets them
die young; at its end the collector resumes its normal schedule.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager

# module state, as the collector it guards is the process's own
_lock = threading.Lock()
_depth = 0          # flushes inside the hold, across threads
_resume = False     # the hold turned the collector off and owes an enable


@contextmanager
def collector_held():
    """Hold the cyclic collector off for the ``with`` block; yields whether
    the hold has it off (False where the caller had turned it off).

    The hold is process-wide: concurrent holders (a pipelined flush's
    worker, a thread pool of shards) share one, and the last one out turns
    the collector back on, only if it was on when the first came in.
    Cyclic garbage made during the hold, in any thread, waits for its end;
    reference counting still frees everything else at once.  Nothing is
    collected, frozen or re-tuned at the boundary: the first allocation
    after it runs the young collection that was due.
    """
    global _depth, _resume
    with _lock:
        if _depth == 0:
            _resume = gc.isenabled()
            if _resume:
                gc.disable()
        _depth += 1
        held = _resume
    try:
        yield held
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0 and _resume:
                _resume = False
                gc.enable()
