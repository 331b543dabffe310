"""mask_h2d_pct.replay: the share of the bytes execute hands the card that
are b x b masks (``RunStats.execute_mask_bytes / execute_h2d_bytes``),
over the window.  None where nothing went to the card or the program does
not count the masks' bytes."""


def read(rec):
    s = rec["stats"]
    v, n = s.get("execute_mask_bytes"), s.get("execute_h2d_bytes")
    return 100.0 * v / n if v is not None and n else None
