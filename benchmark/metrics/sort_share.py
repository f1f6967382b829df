"""Share of the window, in %, spent in stage 1 (preprocess.score_and_sort): the ``sort``
stage wall that ``pipeline.run`` reports, summed over the libraries."""


def read(rec):
    walls = [lib.walls[KEY] for lib in rec.libraries if KEY in lib.walls]
    if not walls or rec.window_s <= 0:
        return None
    return 100.0 * sum(walls) / rec.window_s


KEY = "sort"
