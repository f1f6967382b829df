"""Pairs per launch of the stats kernel over the window: the program's
``ops/align_stats`` LAUNCHES and PAIRS counters."""


def read(rec):
    launches, pairs = rec.launches["stats"]
    return pairs / launches if launches else None
