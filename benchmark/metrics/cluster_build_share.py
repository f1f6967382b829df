"""Share of the window, in %, spent building the clustering's inputs
(``pipeline.cluster_read_array``: the minimizer p-table, the read store,
the gap-pass table): the program's ``cluster.build`` span in
``stage_walls``, summed over the libraries; None where it is absent."""

KEYS = ("cluster.build",)


def read(rec):
    walls = [lib.walls[k] for lib in rec.libraries for k in KEYS
             if k in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s
