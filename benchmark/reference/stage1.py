"""Plain reference of stage 1: score, filter and sort a library's reads.

Upstream NGSpeciesID's contract (modules/get_sorted_fastq_for_cluster.py,
as ``tests/oracle/stage1.py`` writes it down), in NumPy, vectorised over the
reads with one step per base, so that every read sees the same float64
operations in the same order as the per-read loop:

* phred error p(c) = 10 ** (-(c - 33) / 10), capped at 0.79433 for the score;
* score: the expected number of error-free k-mers, a sliding product of
  (1 - p) over windows of k, summed left to right;
* filters: length >= 2k, homopolymer-compressed length >= k, and
  10 * -log10(mean uncapped p) > the quality threshold, the mean accumulated
  over ascending quality characters;
* output: the kept reads by score, descending, ties in input order, each
  accession followed by ``_`` and the score's ``repr``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

#: Per-character error probability, built with CPython's float power.
P_UNCAPPED = np.array([10 ** (-(i - 33) / 10.0) for i in range(128)])
P_CAPPED = np.minimum(P_UNCAPPED, 0.79433)


def parse_fastq(data: bytes) -> List[Tuple[bytes, bytes, bytes]]:
    """(name, seq, qual) of every 4-line record."""
    lines = data.split(b"\n")
    return [(lines[i][1:], lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 3, 4)]


def scores(quals: List[bytes], k: int) -> np.ndarray:
    """Expected error-free k-mers of each read (float64)."""
    n = len(quals)
    lens = np.array([len(q) for q in quals], np.int64)
    width = int(lens.max()) if n else 0
    no_err = np.ones((n, width))
    for r, q in enumerate(quals):
        no_err[r, : len(q)] = 1.0 - P_CAPPED[np.frombuffer(q, np.uint8)]
    prod = np.ones(n)
    for j in range(k):
        prod = prod * no_err[:, j]
    total = prod.copy()
    for j in range(k, width):
        live = j < lens
        step = prod * (no_err[:, j] / no_err[:, j - k])
        prod = np.where(live, step, prod)
        total = np.where(live, total + prod, total)
    n_kmers = (lens - k + 1).astype(np.float64)
    return (1.0 - (n_kmers - total) / n_kmers) * n_kmers


def mean_error(qual: bytes) -> float:
    codes = np.bincount(np.frombuffer(qual, np.uint8), minlength=128)
    total = 0.0
    for c in np.flatnonzero(codes):
        total += float(codes[c]) * float(P_UNCAPPED[c])
    return total / len(qual)


def hpol_length(seq: bytes) -> int:
    s = np.frombuffer(seq, np.uint8)
    return int(1 + np.count_nonzero(s[1:] != s[:-1])) if s.size else 0


def sorted_fastq(data: bytes, k: int, quality_threshold: float) -> bytes:
    """The bytes of ``sorted.fastq`` for the library ``data``."""
    reads = [r for r in parse_fastq(data) if len(r[1]) >= 2 * k]
    sc = scores([q for _, _, q in reads], k) if reads else np.zeros(0)
    kept = []
    for i, (_, seq, qual) in enumerate(reads):
        if hpol_length(seq) < k:
            continue
        e = mean_error(qual)
        if e > 0 and 10 * -math.log(e, 10) > quality_threshold:
            kept.append(i)
    kept.sort(key=lambda i: -sc[i])
    return b"".join(b"@%s_%s\n%s\n+\n%s\n" % (
        reads[i][0], repr(float(sc[i])).encode(), reads[i][1], reads[i][2])
        for i in kept)


def records_differing(got: bytes, want: bytes) -> int:
    """Records of ``got`` that differ from ``want``, position by position,
    plus the difference in their numbers."""
    a, b = parse_fastq(got), parse_fastq(want)
    return abs(len(a) - len(b)) + sum(x != y for x, y in zip(a, b))
