"""Pairs per launch of the moves kernel over the window: the program's
``ops/align_moves`` LAUNCHES and PAIRS counters."""


def read(rec):
    launches, pairs = rec.launches["moves"]
    return pairs / launches if launches else None
