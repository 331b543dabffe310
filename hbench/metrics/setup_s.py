"""setup_s: seconds from the process's start to the measured window
(imports, the card, the kernel library, the stream, the warm-up)."""


def read(rec):
    return rec["setup_s"]
