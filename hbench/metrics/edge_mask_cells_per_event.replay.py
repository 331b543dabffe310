"""edge_mask_cells_per_event.replay: the cells of the per-query edge masks
the per-burst walk built (``RunStats.edge_mask_cells``, b^2 a mask) over
the window, per event."""

from hbench.steps import per_event


def read(rec):
    return per_event(rec, "edge_mask_cells")
