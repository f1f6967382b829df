"""Share of the window, in %, spent in the polish pileup's host walk over
the moves the DP returned (``ops/poa.pileup_stats``): the program's
``poa.walk`` span in ``stage_walls``, summed over the libraries; None where
it is absent."""

KEYS = ("poa.walk",)


def read(rec):
    walls = [lib.walls[k] for lib in rec.libraries for k in KEYS
             if k in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s
