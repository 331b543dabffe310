"""wide_propagate_pct.replay: the share of the cells execute solved
(``RunStats.propagate_cells``, rows x basis columns) that lie in
propagation problems of more than 256 rows (``wide_propagate_cells``),
over the window: where the dense kernel's scan takes its fifth shuffle
round and the masked kernel's copy rings wrap.  None where nothing was
solved or the program does not count the wide problems."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("wide_propagate_cells"), s.get("propagate_cells")
    return 100.0 * v / n if v is not None and n else None
