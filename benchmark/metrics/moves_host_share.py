"""Share of the window, in %, spent on the host side of the moves DP
(``ops/align_moves.sg_moves_pool_torch``): the program's ``moves.stage``
(pool, chunk plan, staging, launches) and ``moves.reconstruct`` spans in
``stage_walls``, summed over the libraries; the wait for the results
(``moves.wait``) is left out.  None where the spans are absent."""

KEYS = ("moves.stage", "moves.reconstruct")


def read(rec):
    walls = [lib.walls[k] for lib in rec.libraries for k in KEYS
             if k in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s
