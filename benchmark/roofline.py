"""The least time a DP launch could take on the card, from its inputs alone.

A pair's work is its in-band interior cells: the cells (i, j), 1 <= i <= len1
and 1 <= j <= len2, that the banded semi-global DP computes.  With band B > 0
a cell on anti-diagonal d = i + j is in the band when

    (d - B) * len1 <= i * (len1 + len2)  and  i * (len1 + len2) < (d + B + 1) * len1,

that is, for row i, d runs over [floor(x) - B, floor(x) + B] with
x = i * (len1 + len2) / len1; band 0 is the full DP, every interior cell.
The count is worked out here from lengths and band, never read from the
program.

Operations per cell (int32): the Gotoh recurrence is 9 (E: open and extend
subtractions and their max, 3; F: the same, 3; the diagonal: compare the
bases and add the substitution score, 2; H: one more max for the 3-way
choice, 1).  The moves DP adds 4 for the move byte (2 compares to pick the
layer, 2 for the E and F open bits): 13.  The stats DP adds 18 for the
path statistics (per layer E, F and diagonal: shift the match history in,
take the bit leaving the window, update the window sum, compare the column
count with k and the window sum with the match threshold and count the
window, 6) and 1 for the diagonal step's match count: 28.

Bytes: each pair's two sequences read once, and its output written once:
16 int32 endpoint trackers for stats; the endpoint row (16 int32) and an
op stream of one byte per anti-diagonal, len1 + len2 + 1, for moves.

Peaks: NVIDIA H100 SXM5, 3.35e12 bytes/s of HBM3 (data sheet) and 33.5e12
int32 operations/s ("Peak INT32 TOPS (non-Tensor)", Hopper architecture
white paper), both at the card's 700 W power limit.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
OPS_PER_CELL = {"stats": 28, "moves": 13}


def band_cells(len1: Iterable[int], len2: Iterable[int], band: int) -> np.ndarray:
    """In-band interior cells of each pair (int64), in blocks of rows."""
    l1 = np.asarray(len1, np.int64).ravel()
    l2 = np.asarray(len2, np.int64).ravel()
    if band <= 0:
        return l1 * l2
    out = np.zeros(l1.size, np.int64)
    tot = l1 + l2
    for s in range(0, l1.size, 256):
        a, b, t = l1[s: s + 256, None], l2[s: s + 256, None], tot[s: s + 256, None]
        i = np.arange(1, int(a.max()) + 1, dtype=np.int64)[None, :]
        fx = (i * t) // a
        lo = np.maximum(fx - band, i + 1)
        hi = np.minimum(fx + band, i + b)
        n = np.clip(hi - lo + 1, 0, None) * (i <= a)
        out[s: s + 256] = n.sum(axis=1)
    return out


def pair_bytes(kind: str, len1, len2) -> np.ndarray:
    """Bytes each pair must move: its sequences in, its outputs out."""
    seq = np.asarray(len1, np.int64) + np.asarray(len2, np.int64)
    if kind == "stats":
        return seq + 16 * 4
    if kind == "moves":
        return seq + 16 * 4 + seq + 1
    raise ValueError(f"no byte count for {kind!r}")


def least_seconds(kind: str, len1, len2, band: int) -> float:
    """The least time for one launch of these pairs: the larger of its bytes
    over the memory rate and its operations over the int32 rate."""
    cells = int(band_cells(len1, len2, band).sum())
    nbytes = int(pair_bytes(kind, len1, len2).sum())
    return max(nbytes / HBM_BYTES_PER_S,
               cells * OPS_PER_CELL[kind] / INT32_OPS_PER_S)
