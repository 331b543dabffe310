"""gc_full_per_mevent.replay: the collector's full (generation-2) passes
(``RunStats.gc_full_collections``, counted through ``gc.callbacks`` while
the program's ``Observability`` is attached) per million events of the
window.  None where the window has no event or the program does not count
full passes."""

from hbench.steps import per_event


def read(rec):
    return per_event(rec, "gc_full_collections", 1e6)
