"""Share of the window, in %, spent on the host side of the stats DP
(``ops/align_stats.sg_stats_pool_torch``): the program's ``stats.stage``
(pool, chunk plan, staging, launches) and ``stats.gather`` spans in
``stage_walls``, summed over the libraries; the wait for the results
(``stats.wait``) is left out.  None where the spans are absent."""

KEYS = ("stats.stage", "stats.gather")


def read(rec):
    walls = [lib.walls[k] for lib in rec.libraries for k in KEYS
             if k in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s
