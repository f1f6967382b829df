"""Share of the window, in %, spent mapping polish reads to centres of
2 kb or more and deriving their windows (``ops/poa.polish_round``'s
anchor-bounded branch: ``ops/mapping.map_reads_to_center`` and
``polish_windows``): the program's ``poa.window`` span in ``stage_walls``,
summed over the libraries; None where it is absent."""

KEYS = ("poa.window",)


def read(rec):
    walls = [lib.walls[k] for lib in rec.libraries for k in KEYS
             if k in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s
