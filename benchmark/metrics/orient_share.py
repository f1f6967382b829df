"""Share of the window, in %, spent orienting the polish reads with the
host minimizer mapper (``ops/poa.orient_reads``,
``ops/mapping.map_reads_to_center``): the program's ``poa.orient`` span in
``stage_walls``, summed over the libraries; None where it is absent."""

KEYS = ("poa.orient",)


def read(rec):
    walls = [lib.walls[k] for lib in rec.libraries for k in KEYS
             if k in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s
