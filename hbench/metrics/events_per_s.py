"""events_per_s: every event of the segments completed in the window over
the time from the window's start to the last completion."""


def read(rec):
    return rec["events"] / rec["window_s"]
