"""Share of the window, in %, spent in the polish phase's file work
(``consensus/stage.polish_sequences``: clearing old outputs, pooling the
clusters' reads, writing them and the reference and consensus files): the
program's ``polish.files`` span in ``stage_walls``, summed over the
libraries; None where it is absent."""

KEYS = ("polish.files",)


def read(rec):
    walls = [lib.walls[k] for lib in rec.libraries for k in KEYS
             if k in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s
