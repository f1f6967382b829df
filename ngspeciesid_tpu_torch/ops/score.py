"""Read scoring: expected number of error-free k-mers, batched and bit-exact.

The reference computes, per read, the expected number of erroneous k-mers via
a sequential sliding-window product over (1 - p_err) (reference
get_sorted_fastq_for_cluster.py:23-33) and sorts reads by
``score = (1 - E[err kmers]/(L-k+1)) * (L-k+1)``.  The printed score is part
of the output-file contract (it is appended to every accession), so we need
bit-exact float64 parity with the reference's sequential rounding — but
vectorized.

Key identity: the reference's recurrence

    q_0   = w_0 * w_1 * ... * w_{k-1}            (left-to-right)
    q_j   = q_{j-1} * (w_{k-1+j} / w_{j-1})
    S     = q_0 + q_1 + ... + q_M                (left-to-right)

is exactly ``cumsum(cumprod(f)[k-1:])[-1]`` for the factor vector
``f = [w_0..w_{k-1}, r_1..r_M]``: numpy's cumprod/cumsum are sequential, so
every intermediate rounding matches the Python loop.  Padding rows with 1.0
(for cumprod) and 0.0 (for cumsum) is exact, which makes the whole thing a
single padded 2-D computation over a batch of reads.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..utils.phred import PHRED_TO_P, PHRED_TO_P_CAPPED


def batch_scores(quals: Sequence[np.ndarray], k: int) -> np.ndarray:
    """Bit-exact scores for a batch of quality byte arrays (equal contract as
    reference get_sorted_fastq_for_cluster.py:139-141).

    quals: list of uint8 arrays (ASCII phred codes), each of length >= k.
    Returns float64 scores.
    """
    n = len(quals)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    lens = np.array([q.size for q in quals], dtype=np.int64)
    lmax = int(lens.max())
    cols = np.arange(lmax)
    in_read = cols[None, :] < lens[:, None]
    # padded (1 - p_err) matrix from the ragged batch in one scatter
    W = np.ones((n, lmax), dtype=np.float64)
    W[in_read] = 1.0 - PHRED_TO_P_CAPPED[np.concatenate(quals)]
    # factors: first k raw windows values, then the ratio w[j] / w[j-k];
    # padded cells forced to exactly 1.0 (selection, not arithmetic, so the
    # cumprod stays bit-identical to the per-read recurrence)
    factors = W.copy()
    factors[:, k:] = np.where(in_read[:, k:], W[:, k:] / W[:, :-k], 1.0)
    c = np.cumprod(factors, axis=1)[:, k - 1 :]
    c[~in_read[:, k - 1 :]] = 0.0
    sum_exp = np.cumsum(c, axis=1)[:, -1]
    n_kmers = (lens - k + 1).astype(np.float64)
    expected_err = n_kmers - sum_exp
    p_no_err = 1.0 - expected_err / n_kmers
    return p_no_err * n_kmers


def batch_error_rates(quals: Sequence[np.ndarray], capped: bool = False) -> np.ndarray:
    """Average per-base error probability per read (float64).

    Accumulates ``count(c) * p(c)`` over ascending byte values — deterministic,
    unlike the reference's hash-ordered set iteration
    (get_sorted_fastq_for_cluster.py:62-63,145-146) which varies in the last
    ulps between runs.
    """
    n = len(quals)
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    lens = np.array([q.size for q in quals], dtype=np.int64)
    row_ids = np.repeat(np.arange(n), lens)
    flat = np.concatenate(quals).astype(np.int64)
    counts = np.zeros((n, 128), dtype=np.float64)
    np.add.at(counts, (row_ids, flat), 1.0)
    table = PHRED_TO_P_CAPPED if capped else PHRED_TO_P
    return np.cumsum(counts * table, axis=1)[:, -1] / lens.astype(np.float64)


def score_single(qual: str, k: int) -> float:
    """Convenience scalar wrapper (used by tests)."""
    q = np.frombuffer(qual.encode("ascii"), dtype=np.uint8)
    return float(batch_scores([q], k)[0])
