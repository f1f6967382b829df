"""Input reads of the window's completed libraries per second of the window."""


def read(rec):
    if rec.window_s <= 0:
        return None
    return sum(lib.reads for lib in rec.libraries if lib.ok) / rec.window_s
