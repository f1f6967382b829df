"""Phred quality tables as numpy arrays.

The behavioural contract (reference: modules/get_sorted_fastq_for_cluster.py:20-21
and modules/cluster.py:233) defines two byte-indexed error-probability tables:

  * a capped table   p(c) = min(10^(-(ord(c)-33)/10), 0.79433)  — used for the
    expected-error-free-kmer score and for homopolymer-compressed error rates,
  * an uncapped table p(c) = 10^(-(ord(c)-33)/10)               — used for the
    per-read average error rate that drives the quality filter.

We precompute both for all 128 ASCII codes in float64 so that any byte string
can be mapped with a single fancy-index gather.
"""

from __future__ import annotations

import numpy as np

# Built with CPython float pow so every entry is bit-identical to the
# behavioural contract's ``10 ** (-(ord(c) - 33) / 10.0)`` — numpy's SIMD
# pow can differ in the last ulp.
#: Uncapped per-character error probability, indexed by ASCII code.
PHRED_TO_P = np.array([10 ** (-(i - 33) / 10.0) for i in range(128)], dtype=np.float64)

#: Error probability capped at 0.79433 (the reference's floor for Q<1 chars).
PHRED_TO_P_CAPPED = np.minimum(PHRED_TO_P, 0.79433)


def qual_bytes(qual: str) -> np.ndarray:
    """Quality string -> uint8 ASCII codes."""
    return np.frombuffer(qual.encode("ascii"), dtype=np.uint8)


def error_probs(qual: str, capped: bool = True) -> np.ndarray:
    """Per-base error probabilities (float64) for a quality string."""
    table = PHRED_TO_P_CAPPED if capped else PHRED_TO_P
    return table[qual_bytes(qual)]


def poisson_error_rate(qual: str, capped: bool = False) -> float:
    """Average per-base error probability of a quality string.

    Matches the reference's ``sum(qual.count(c) * D[c] for c in set(qual)) /
    len(qual)`` (get_sorted_fastq_for_cluster.py:62-63,145-146) except that we
    accumulate over ascending byte values, which is deterministic; the
    reference iterates a Python set whose order is hash-randomised, so its
    result varies in the last ulps from run to run.
    """
    codes = qual_bytes(qual)
    counts = np.bincount(codes, minlength=128).astype(np.float64)
    table = PHRED_TO_P_CAPPED if capped else PHRED_TO_P
    return float(np.cumsum(counts * table)[-1] / len(qual))
