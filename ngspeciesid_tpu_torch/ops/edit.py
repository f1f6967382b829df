"""Infix (semi-global in text) edit distance with IUPAC wildcards.

TPU-native replacement for the reference's edlib usage (N2 in SURVEY.md):
``edlib.align(primer, center, mode="HW", task="locations", k,
additionalEqualities=IUPAC_map)`` (reference barcode_trimmer.py:34-58).

Semantics reproduced:
  * distance = min Levenshtein distance between the query and ANY substring
    of the target (free leading/trailing target bases), counting IUPAC
    equivalences as matches; -1 if it exceeds ``k``;
  * the first reported location is the SMALLEST end position achieving the
    optimal distance (end inclusive), with the smallest compatible start.

The row recurrence's horizontal chain (consume a target base) is rewritten
as a running min — ``D[i][j] = min(M[i][j''] + (j - j''))`` over j'' <= j —
so each query row is one vectorized ``minimum.accumulate`` over the target
axis; queries are primer-sized (tens of bases), targets are trim windows
(<= ~150 bases), so the whole search over all (primer, window) pairs is a
handful of small vector ops.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# IUPAC equivalence pairs (symmetric), as fixed by the behavioural contract
# (barcode_trimmer.py:41-46).
IUPAC_PAIRS = [
    ("A", "A"), ("C", "C"), ("G", "G"), ("T", "T"), ("M", "A"), ("M", "C"),
    ("R", "A"), ("R", "G"), ("W", "A"), ("W", "T"), ("S", "C"), ("S", "G"),
    ("Y", "C"), ("Y", "T"), ("K", "G"), ("K", "T"), ("V", "A"), ("V", "C"),
    ("V", "G"), ("H", "A"), ("H", "C"), ("H", "T"), ("D", "A"), ("D", "G"),
    ("D", "T"), ("B", "C"), ("B", "G"), ("B", "T"), ("X", "G"), ("X", "A"),
    ("X", "T"), ("X", "C"), ("N", "G"), ("N", "A"), ("N", "T"), ("N", "C"),
]

_EQ = np.zeros((256, 256), dtype=bool)
np.fill_diagonal(_EQ, True)
for _a, _b in IUPAC_PAIRS:
    _EQ[ord(_a), ord(_b)] = True
    _EQ[ord(_b), ord(_a)] = True


def _dp_rows(query: np.ndarray, target: np.ndarray, anchored: bool = False) -> np.ndarray:
    """Final DP row over target prefixes.

    anchored=False: D[j] = min edit distance of query vs any target substring
    ending at j (exclusive) — free start (Sellers).
    anchored=True:  D[j] = Levenshtein(query, target[:j]) — start fixed at 0.
    """
    m, n = query.size, target.size
    jj = np.arange(n + 1, dtype=np.int64)
    D = jj.copy() if anchored else np.zeros(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        sub = np.where(_EQ[query[i - 1], target], 0, 1)
        M = np.empty(n + 1, dtype=np.int64)
        M[0] = i  # all-deletions prefix
        M[1:] = np.minimum(D[:-1] + sub, D[1:] + 1)
        D = jj + np.minimum.accumulate(M - jj)
    return D


def infix_search(
    query: np.ndarray, target: np.ndarray, max_ed: int
) -> Optional[Tuple[int, int, int]]:
    """First optimal hit of ``query`` inside ``target``.

    Returns ``(start, end_inclusive, edit_distance)`` or None when the best
    distance exceeds ``max_ed``.  The end is the smallest position achieving
    the optimal distance; the start is the smallest start compatible with it.
    """
    if query.size == 0 or target.size == 0:
        return None
    D = _dp_rows(query, target)
    best = int(D[1:].min()) if target.size else int(D[0])
    if best > max_ed:
        return None
    end = int(np.argmin(D[1:])) + 1  # smallest end (exclusive) with best ed
    # smallest start: anchored reverse DP; Dr[j] = dist(query, target[end-j:end])
    rq = query[::-1]
    rt = target[:end][::-1]
    Dr = _dp_rows(rq, rt, anchored=True)
    js = np.flatnonzero(Dr == best)
    j = int(js.max())  # largest span -> smallest start
    return end - j, end - 1, best


def find_in_window(
    queries: List[np.ndarray], target: np.ndarray, max_ed: int
) -> List[Optional[Tuple[int, int, int]]]:
    """Infix search of several primers in one window."""
    return [infix_search(q, target, max_ed) for q in queries]
