"""Share of the window, in %, spent in the clustering engine's conflict
scan: ``cluster/engine.PERF_COUNTERS["conflict_s"]``, summed over the
libraries."""


def read(rec):
    if rec.window_s <= 0 or not rec.libraries:
        return None
    return 100.0 * sum(lib.engine.get("conflict_s", 0.0)
                       for lib in rec.libraries) / rec.window_s
