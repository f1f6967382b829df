"""Spans: the host seconds and counts of named pieces of the port's work.

``span(name)`` times a block with ``time.perf_counter`` and adds its
seconds to the current sink under ``name``; ``count(name, n)`` adds ``n``
there.  The sink is the ``stage_walls`` dict that ``cli.main`` takes and
``pipeline.run`` fills: ``run`` makes it the current sink for the run's
length (``sink``) and then restores the one before.  With no sink set a
span records nothing; its ``seconds`` still hold the block's time.

There is one sink for the process, and every addition to it takes a lock,
so the rank threads of ``parallel/dist.py`` (``GlooWorld``,
``ThreadWorld``) all add to it: under NGSID_DISTRIBUTED=1 with ranks as
threads of one process, a span's seconds are summed over the threads that
opened it and can exceed the wall.

While a ``torch.profiler`` is recording (the benchmark's traced runs,
``--profile``), a span also opens ``torch.profiler.record_function(name)``,
so that the spans lie on the trace's timeline beside the device's work.
A span never synchronises the device, launches work or copies data.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

import torch

_LOCK = threading.Lock()
_SINK: Optional[Dict[str, float]] = None


@contextmanager
def sink(walls: Dict[str, float]) -> Iterator[Dict[str, float]]:
    """Make ``walls`` the current sink inside the block."""
    global _SINK
    with _LOCK:
        prev, _SINK = _SINK, walls
    try:
        yield walls
    finally:
        with _LOCK:
            _SINK = prev


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the current sink under ``name``."""
    with _LOCK:
        if _SINK is not None:
            _SINK[name] = _SINK.get(name, 0) + n


class span:
    """A timed block; ``seconds`` is its time once it has closed."""

    __slots__ = ("name", "seconds", "_t0", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self.seconds = 0.0
        self._range = None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._t0
        count(self.name, self.seconds)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None

