"""Batched semi-global (overlap) alignment with affine gaps: numpy oracle
and the stats-only dispatch.

Port of ngspeciesid_tpu/ops/align.py without its JAX row-scan DP: the numpy
oracle (``sg_dp_numpy``, traceback, match vector, window stats, identity),
its batched mirror, and the dispatch ``block_stats_batch`` /
``identity_batch`` over the backends of :mod:`ngspeciesid_tpu_torch.device`.

Scoring follows the reference's parasail usage: match/mismatch over "ACGT",
affine gaps where a gap of length L costs ``open + (L-1) * ext``, and FREE
terminal gaps on both sequences (reference cluster.py:130-142,
consensus.py:58-73).  Alignment columns include terminal gaps.

Determinism: when scores tie, moves prefer diagonal > gap-in-s2 (up) >
gap-in-s1 (left), and the alignment endpoint prefers the (n, m)-corner-most
cell of the last row, then of the last column.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..device import stats_backend_default, stats_device

NEG_INF = np.int32(-(2**30))

# move codes in the H-choice matrix
DIAG, UP, LEFT = 1, 2, 3  # UP = gap in s2 (consume s1), LEFT = gap in s1


# ---------------------------------------------------------------------------
# numpy implementation (oracle + small-batch host path)
# ---------------------------------------------------------------------------

def sg_dp_numpy(
    s1: np.ndarray, s2: np.ndarray, match: int = 2, mismatch: int = -2,
    gap_open: int = 5, gap_ext: int = 1,
) -> Tuple[int, np.ndarray, Tuple[int, int]]:
    """Full Gotoh DP (sequential host oracle).

    Returns ``(score, packed, end)`` where packed is (n+1, m) uint8 with
    move code in bits 0-1, Eopen in bit 2, Fopen in bit 3 for columns 1..m
    (same layout as the device kernel).
    """
    n, m = s1.size, s2.size
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    packed = np.zeros((n + 1, m), dtype=np.uint8)
    F = np.full((m + 1,), NEG_INF, dtype=np.int64)
    Hprev = H[0]
    for i in range(1, n + 1):
        Hcur = np.empty(m + 1, dtype=np.int64)
        Hcur[0] = 0  # free leading gap in s2
        sub = np.where(s2 == s1[i - 1], match, mismatch)
        f_open = Hprev - gap_open
        f_ext = F - gap_ext
        fopen_row = f_open >= f_ext
        F = np.maximum(f_open, f_ext)
        e = NEG_INF
        for j in range(1, m + 1):
            e_open = Hcur[j - 1] - gap_open
            e_ext = e - gap_ext
            eopen = e_open >= e_ext
            e = e_open if eopen else e_ext
            diag = Hprev[j - 1] + sub[j - 1]
            h, mv = diag, DIAG
            if F[j] > h:
                h, mv = F[j], UP
            if e > h:
                h, mv = e, LEFT
            Hcur[j] = h
            packed[i, j - 1] = mv | (int(eopen) << 2) | (int(fopen_row[j]) << 3)
        Hprev = Hcur
        H[i] = Hcur
    score, end = _best_end(H, n, m)
    return int(score), packed, end


def _best_end(H: np.ndarray, n: int, m: int) -> Tuple[int, Tuple[int, int]]:
    """Endpoint: max score over last row/col; prefer corner-most in last row,
    then corner-most in last column."""
    best = None
    # last row, j descending (corner first)
    row = H[n, :]
    col = H[:, m]
    jmax = int(np.argmax(row[::-1]))
    j_best = m - jmax
    imax = int(np.argmax(col[::-1]))
    i_best = n - imax
    if row[j_best] >= col[i_best]:
        best = (int(row[j_best]), (n, j_best))
    else:
        best = (int(col[i_best]), (i_best, m))
    return best


def traceback_moves(
    packed: np.ndarray, n: int, m: int, end: Tuple[int, int]
) -> np.ndarray:
    """Decode the alignment column moves (full-span, terminal gaps included).

    ``packed``: (n+1, m) uint8, bits 0-1 move, bit 2 Eopen, bit 3 Fopen,
    column j stored at index j-1.  Returns move codes (DIAG/UP/LEFT)
    covering all of s1 and s2.
    """
    i, j = end
    ops: List[int] = []
    ops.extend([UP] * (n - i))     # terminal gap: unaligned s1 suffix
    ops.extend([LEFT] * (m - j))   # terminal gap: unaligned s2 suffix
    state = 0  # 0 = in H, 1 = in E (left-gap run), 2 = in F (up-gap run)
    while i > 0 and j > 0:
        cell = packed[i, j - 1]
        if state == 0:
            mv = cell & 3
            if mv == DIAG:
                ops.append(DIAG)
                i -= 1
                j -= 1
            elif mv == LEFT:
                state = 1
            else:
                state = 2
        elif state == 1:
            ops.append(LEFT)
            opened = cell & 4
            j -= 1
            if opened:
                state = 0
        else:
            ops.append(UP)
            opened = cell & 8
            i -= 1
            if opened:
                state = 0
    ops.extend([UP] * i)
    ops.extend([LEFT] * j)
    return np.array(ops[::-1], dtype=np.uint8)


def match_vector(moves: np.ndarray, s1: np.ndarray, s2: np.ndarray) -> np.ndarray:
    """Per-alignment-column match indicator (gap columns are mismatches)."""
    i = np.cumsum(moves != LEFT)  # s1 index (1-based) at each column
    j = np.cumsum(moves != UP)
    is_diag = moves == DIAG
    out = np.zeros(moves.size, dtype=np.int32)
    idx = np.flatnonzero(is_diag)
    out[idx] = (s1[i[idx] - 1] == s2[j[idx] - 1]).astype(np.int32)
    return out


def block_aligned_stats(
    mv: np.ndarray, k: int, match_id: int, len1: int, len2: int
) -> Tuple[float, float]:
    """Rolling-window aligned-region ratios (reference cluster.py:144-168).

    A window of k consecutive alignment columns counts as 'aligned' if it has
    at least ``match_id`` matches; ratio = #aligned windows / len(s).
    """
    if mv.size < k:
        return 0.0, 0.0
    window_sums = np.convolve(mv, np.ones(k, dtype=np.int32), mode="valid")
    aligned = int(np.count_nonzero(window_sums >= match_id))
    return aligned / float(len1), aligned / float(len2)


def identity_from_moves(moves: np.ndarray, s1: np.ndarray, s2: np.ndarray) -> float:
    """Column identity over the full alignment span (consensus.py:129-145)."""
    mv = match_vector(moves, s1, s2)
    return float(mv.sum()) / float(moves.size)


def _sg_dp_np_batch(
    s1b: np.ndarray, s2b: np.ndarray, len1: np.ndarray, len2: np.ndarray,
    match: int, mismatch: int, gap_open: np.ndarray, gap_ext: int,
):
    """Batched numpy Gotoh DP (same recurrences and tie-breaking as
    :func:`sg_dp_numpy`; row loop in Python, columns and batch vectorized)."""
    B, n = s1b.shape
    m = s2b.shape[1]
    NEG = np.int32(NEG_INF)
    jj = np.arange(1, m + 1, dtype=np.int32)
    go = gap_open[:, None].astype(np.int32)
    col_valid_h = np.concatenate(
        [np.ones((B, 1), bool), jj[None, :] <= len2[:, None]], axis=1)
    H = np.where(col_valid_h, np.zeros((B, m + 1), np.int32), NEG)
    F = np.full((B, m + 1), NEG, np.int32)
    last_row = H.copy()
    packed = np.zeros((B, n + 1, m), dtype=np.uint8)
    col_vals = np.empty((B, n + 1), dtype=np.int32)
    col_vals[:, 0] = np.take_along_axis(H, len2[:, None], axis=1)[:, 0]
    ar = np.arange(B)
    for i in range(1, n + 1):
        valid_i = (i <= len1)[:, None]
        sub = np.where(s2b == s1b[:, i - 1][:, None], match, mismatch).astype(np.int32)
        f_open = H - go
        f_ext = F - gap_ext
        fopen_row = f_open >= f_ext
        Fn = np.maximum(f_open, f_ext)
        diag = H[:, :-1] + sub
        h_no_e = np.maximum(diag, Fn[:, 1:])
        prevH = np.concatenate([np.zeros((B, 1), np.int32), h_no_e[:, :-1]], axis=1)
        g = prevH - go + jj[None, :] * gap_ext
        T = np.maximum.accumulate(g, axis=1)
        E = T - jj[None, :] * gap_ext
        eopen_row = g >= T
        moves_row = np.where(
            E > h_no_e, np.uint8(LEFT),
            np.where(Fn[:, 1:] > diag, np.uint8(UP), np.uint8(DIAG)),
        )
        packed_row = (moves_row
                      | (eopen_row.astype(np.uint8) << 2)
                      | (fopen_row[:, 1:].astype(np.uint8) << 3))
        packed[:, i, :] = np.where(valid_i, packed_row, 0)
        Hrow = np.concatenate(
            [np.zeros((B, 1), np.int32), np.maximum(h_no_e, E)], axis=1)
        Hrow = np.where(col_valid_h, Hrow, NEG)
        H = np.where(valid_i, Hrow, H)
        F = np.where(valid_i, Fn, F)
        last_row = np.where((i == len1)[:, None], H, last_row)
        col_vals[:, i] = H[ar, len2]

    def corner_argmax(x, valid_len):
        idx = np.arange(x.shape[1])
        masked = np.where(idx[None] <= valid_len[:, None], x, NEG)
        best = masked.max(axis=1)
        pick = np.where(masked == best[:, None], idx[None], -1).max(axis=1)
        return best, pick

    row_best, row_j = corner_argmax(last_row, len2)
    col_best, col_i = corner_argmax(col_vals, len1)
    use_row = row_best >= col_best
    scores = np.where(use_row, row_best, col_best)
    end_i = np.where(use_row, len1, col_i)
    end_j = np.where(use_row, row_j, len2)
    return scores, end_i, end_j, packed


def _pad_batch(seqs: List[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(seqs), width), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : s.size] = s
    return out


def _bucket_width(x: int) -> int:
    """Coarse length bucket (64, 128, ..., 1024, then +512 steps): the stats
    DP groups pairs by it (``align_stats._plan_chunks``)."""
    w = 64
    while w < x:
        w = w * 2 if w < 1024 else w + 512
    return w


def sg_align_batch(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    backend: Optional[str] = None,
    band: int = 0,
) -> List[np.ndarray]:
    """Align a batch of byte-sequence pairs; return per-pair move arrays
    (full alignment columns incl. terminal gaps).

    backend: "native" (C++ engine), "numpy", or None for native when it
    builds, else numpy.  band > 0 restricts the native DP to +-band of the
    scaled main diagonal; the numpy mirror always runs the full DP."""
    if not pairs:
        return []
    B = len(pairs)
    if backend is None:
        from ngspeciesid_tpu import native
        backend = "native" if native.available() else "numpy"
    if backend == "native":
        from ngspeciesid_tpu import native
        return native.align_batch_native(pairs, gap_opens, match, mismatch,
                                         gap_ext, band=band)
    if backend != "numpy":
        raise ValueError(f"unknown alignment backend {backend!r}")
    # numpy mirror has no compile cost: pad tightly
    n = -(-max(a.size for a, _ in pairs) // 64) * 64
    m = -(-max(b.size for _, b in pairs) // 64) * 64
    # bound the packed-move matrix memory by chunking large batches
    max_chunk = max(1, (256 << 20) // max(1, (n + 1) * m))
    if B > max_chunk:
        out: List[np.ndarray] = []
        for s in range(0, B, max_chunk):
            out.extend(
                sg_align_batch(pairs[s : s + max_chunk], gap_opens[s : s + max_chunk],
                               match, mismatch, gap_ext, backend, band)
            )
        return out
    s1b = _pad_batch([a for a, _ in pairs], n)
    s2b = _pad_batch([b for _, b in pairs], m)
    len1 = np.array([a.size for a, _ in pairs], dtype=np.int32)
    len2 = np.array([b.size for _, b in pairs], dtype=np.int32)
    opens = np.asarray(gap_opens, dtype=np.int32)
    scores, end_i, end_j, packed = _sg_dp_np_batch(
        s1b, s2b, len1, len2, match, mismatch, opens, gap_ext
    )
    out = []
    for b in range(B):
        out.append(
            traceback_moves(packed[b], int(len1[b]), int(len2[b]),
                            (int(end_i[b]), int(end_j[b])))
        )
    return out


def sg_align_numpy(
    s1: np.ndarray, s2: np.ndarray, gap_open: int,
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
) -> np.ndarray:
    """Single-pair host path returning alignment moves (oracle-grade)."""
    score, packed, end = sg_dp_numpy(s1, s2, match, mismatch, gap_open, gap_ext)
    return traceback_moves(packed, s1.size, s2.size, end)


# ---------------------------------------------------------------------------
# stats-only dispatch: the two statistics every consumer actually needs
# ---------------------------------------------------------------------------

def block_stats_batch(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int], ks: List[int], match_ids: List[int],
    band: int = 0, backend: Optional[str] = None,
) -> List[Tuple[float, float]]:
    """Per-pair (aligned_ratio_s1, aligned_ratio_s2) of the reference's
    rolling-k-window fallback statistic (cluster.py:144-168) on ``backend``
    (default: :func:`stats_backend_default`).  ``cuda`` sends every batch,
    however small, through the kernel."""
    if not pairs:
        return []
    backend = backend or stats_backend_default()
    if backend == "native":
        from ngspeciesid_tpu import native
        return native.block_stats_native(pairs, gap_opens, ks, match_ids,
                                         band=band)
    if backend in ("cuda", "torch"):
        from .align_stats import block_stats_torch
        return block_stats_torch(pairs, gap_opens, ks, match_ids, band=band,
                                 device=stats_device(backend))
    moves = sg_align_batch(pairs, gap_opens, band=band)
    out = []
    for t, (a, b) in enumerate(pairs):
        mv = match_vector(moves[t], a, b)
        out.append(block_aligned_stats(mv, ks[t], match_ids[t], a.size, b.size))
    return out


def identity_batch(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    band: int = 0, backend: Optional[str] = None,
) -> List[float]:
    """Per-pair column identity (consensus.py:129-145) on ``backend``."""
    if not pairs:
        return []
    backend = backend or stats_backend_default()
    if backend == "native":
        from ngspeciesid_tpu import native
        return native.identity_native(pairs, gap_opens, band=band)
    if backend in ("cuda", "torch"):
        from .align_stats import identity_torch
        return identity_torch(pairs, gap_opens, band=band,
                              device=stats_device(backend))
    moves = sg_align_batch(pairs, gap_opens, band=band)
    return [identity_from_moves(moves[t], a, b)
            for t, (a, b) in enumerate(pairs)]
