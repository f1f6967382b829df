"""Lexicographic k-mer minimizers, vectorized.

Reproduces the exact emission semantics of the behavioural contract
(reference modules/cluster.py:16-39):

  * k-mers are taken over a sliding window of ``w - k + 1`` k-mer start
    positions of the (homopolymer-compressed) sequence;
  * the first window emits ``(min_kmer, first_index_of_min)``;
  * for each subsequent window ending at k-mer position j:
      - if the k-mer that just left the window EQUALS the previous window's
        minimum value, re-emit the new window's minimum with its first
        occurrence position (even when the value is unchanged — consecutive
        duplicate emissions are part of the contract);
      - else if the entering k-mer is STRICTLY smaller than the previous
        minimum, emit ``(new_kmer, j)``;
  * when the sequence is shorter than ``w``, the first window still spans
    ``w - k + 1`` start positions, so it contains *truncated* k-mers
    (Python slice semantics); their lexicographic order must be preserved.

Encoding: each character is mapped to its rank (1-based) in the ascending
byte order of the alphabet present in the data; k-mers are packed into int64
with RANK_BITS bits per character, short/truncated k-mers padded with rank 0.
Rank packing preserves lexicographic order and equality, including the
prefix-sorts-first rule for truncated k-mers.  k up to 15 fits 4-bit ranks in
60 bits for alphabets up to 15 symbols; larger alphabets/k fall back to wider
rank bits while they fit, else a uint8-matrix comparison path.

The sliding-window min/argmin is computed with a strided-window reduction —
the window is tiny (w - k + 1 = 8 for ONT defaults) so the O(L * win) batch
reduction is both simple and fast, and it vectorizes across a padded batch of
reads on device or host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_SENTINEL = np.int64(np.iinfo(np.int64).max)


def kmer_codes(seq: np.ndarray, k: int, rank_of: np.ndarray, rank_bits: int) -> np.ndarray:
    """Pack every k-mer start position 0..len(seq)-1 into an int64 code.

    Positions within ``len(seq)-k+1`` are full k-mers; later ones are the
    truncated suffix k-mers (padded with rank 0) that the contract's first
    window can contain.  Returns an array of length len(seq).
    """
    n = seq.size
    ranks = rank_of[seq].astype(np.int64)
    codes = np.zeros(n, dtype=np.int64)
    for offset in range(k):
        shifted = np.zeros(n, dtype=np.int64)
        shifted[: n - offset] = ranks[offset:]
        codes = (codes << rank_bits) | shifted
    return codes


def alphabet_ranks(alphabet_bytes: np.ndarray) -> Tuple[np.ndarray, int]:
    """Rank table (uint8 byte -> 1-based rank) and the bit width per rank."""
    uniq = np.unique(alphabet_bytes)
    rank_of = np.zeros(256, dtype=np.int64)
    rank_of[uniq] = np.arange(1, uniq.size + 1)
    rank_bits = max(int(np.ceil(np.log2(uniq.size + 1))), 1)
    return rank_of, rank_bits


def minimizers_from_codes(codes: np.ndarray, k: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Minimizer (code, position) pairs for one sequence's k-mer codes.

    ``codes`` must cover ALL positions 0..L-1 (truncated tail k-mers included)
    as produced by :func:`kmer_codes`; L = len(sequence) >= k.
    """
    L = codes.size
    win = w - k + 1  # number of k-mer start positions per window
    n_kmers = L - k + 1

    if n_kmers <= win:
        # Single (possibly truncated) window over positions [0, win) — note the
        # contract includes truncated k-mers here when L < w, and even EMPTY
        # k-mers (code 0, the global minimum) when L < w - k + 1.
        if win > L:
            first = np.concatenate([codes, np.zeros(win - L, dtype=np.int64)])
        else:
            first = codes[:win]
        arg = int(np.argmin(first))
        return first[arg : arg + 1], np.array([arg], dtype=np.int64)

    kmers = codes[:n_kmers]
    # windows[j] spans kmer positions [j, j+win) for j in 0..n_kmers-win
    n_win = n_kmers - win + 1
    strided = np.lib.stride_tricks.sliding_window_view(kmers, win)
    mins = strided.min(axis=1)
    argmins = strided.argmin(axis=1) + np.arange(n_win)

    # Emission conditions (see module docstring).  Window index j corresponds
    # to the contract's loop index i = j + win - 1 over entering k-mers.
    emit_left = kmers[: n_win - 1] == mins[: n_win - 1]   # leaving kmer was the min
    entering = kmers[win:]
    emit_new = (~emit_left) & (entering < mins[: n_win - 1])

    emit = np.empty(n_win, dtype=bool)
    emit[0] = True
    emit[1:] = emit_left | emit_new

    out_codes = np.where(
        np.concatenate(([True], emit_left)), mins, np.concatenate(([mins[0]], entering))
    )
    out_pos = np.where(
        np.concatenate(([True], emit_left)),
        argmins,
        np.concatenate(([argmins[0]], np.arange(win, n_kmers))),
    )
    return out_codes[emit], out_pos[emit]


def sequence_minimizers(
    seq: np.ndarray, k: int, w: int, rank_of: np.ndarray, rank_bits: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Minimizers of a byte sequence (already homopolymer-compressed)."""
    codes = kmer_codes(seq, k, rank_of, rank_bits)
    return minimizers_from_codes(codes, k, w)


def _batch_minimizers_padded(
    seqs: List[np.ndarray], k: int, w: int, rank_of: np.ndarray, rank_bits: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Vectorized minimizer extraction for a chunk of sequences of length
    >= max(k, w - k + 1): pads the chunk into one (B, Lmax) matrix and runs
    k-mer packing, the strided window min/argmin, and the emission rules as
    whole-matrix ops.  Semantically identical to per-read
    :func:`minimizers_from_codes` (covered by the same property tests)."""
    B = len(seqs)
    win = w - k + 1
    lens = np.array([s.size for s in seqs], dtype=np.int64)
    lmax = int(lens.max())
    mat = np.zeros((B, lmax), dtype=np.uint8)
    in_read = np.arange(lmax)[None, :] < lens[:, None]
    mat[in_read] = np.concatenate(seqs)
    # packed k-mer codes at every position (truncated tail k-mers included)
    ranks = rank_of[mat]
    ranks[~in_read] = 0
    codes = np.zeros((B, lmax), dtype=np.int64)
    for offset in range(k):
        shifted = np.zeros((B, lmax), dtype=np.int64)
        shifted[:, : lmax - offset] = ranks[:, offset:]
        codes = (codes << rank_bits) | shifted
    n_kmers = lens - k + 1
    # positions beyond each read's kmer range must never win a window
    kmer_valid = np.arange(lmax)[None, :] < n_kmers[:, None]
    kmers = np.where(kmer_valid, codes, _SENTINEL)
    n_win = lmax - k + 1 - win + 1
    if n_win < 1:
        return [sequence_minimizers(s, k, w, rank_of, rank_bits) for s in seqs]
    strided = np.lib.stride_tricks.sliding_window_view(kmers[:, : lmax - k + 1], win, axis=1)
    mins = strided.min(axis=2)                       # (B, n_win)
    argmins = strided.argmin(axis=2) + np.arange(n_win)[None, :]
    emit_left = kmers[:, : n_win - 1] == mins[:, : n_win - 1]
    entering = kmers[:, win : win + n_win - 1]
    emit_new = (~emit_left) & (entering < mins[:, : n_win - 1])
    emit = np.concatenate([np.ones((B, 1), bool), emit_left | emit_new], axis=1)
    win_valid = np.arange(n_win)[None, :] <= (n_kmers - win)[:, None]
    emit &= win_valid
    out_codes = np.where(
        np.concatenate([np.ones((B, 1), bool), emit_left], axis=1),
        mins,
        np.concatenate([mins[:, :1], entering], axis=1),
    )
    out_pos = np.where(
        np.concatenate([np.ones((B, 1), bool), emit_left], axis=1),
        argmins,
        np.concatenate([argmins[:, :1],
                        np.broadcast_to(np.arange(win, win + n_win - 1)[None, :],
                                        (B, n_win - 1))], axis=1),
    )
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for b in range(B):
        sel = emit[b]
        out.append((out_codes[b][sel].astype(np.int64),
                    out_pos[b][sel].astype(np.int64)))
    return out


_CHUNK = 512


def batch_minimizers_flat(
    flat: np.ndarray, offsets: np.ndarray, k: int, w: int,
    rank_of: np.ndarray, rank_bits: int,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """batch_minimizers over rows of one contiguous buffer (row b spans
    flat[offsets[b], offsets[b+1])): the native engine reads in place —
    zero staging copies.  Falls back to slicing + batch_minimizers."""
    import os

    if k * rank_bits <= 62 and os.environ.get("NGSID_MINIMIZERS") != "python":
        from .. import native

        if native.available():
            return native.minimizers_flat_native(
                flat, offsets, k, w, rank_of, rank_bits)
    rows = [flat[offsets[i]:offsets[i + 1]] for i in range(offsets.size - 1)]
    return batch_minimizers(rows, k, w, rank_of, rank_bits)


def batch_minimizers(
    seqs: List[np.ndarray], k: int, w: int, rank_of: np.ndarray, rank_bits: int
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Minimizers for a batch of byte sequences: native sequential-scan fast
    path when the engine is built (bit-identical emissions, see sgdp.cpp),
    else chunked padded-matrix numpy with a per-read fallback for short/edge
    cases.  Sequences shorter than k yield empty results (callers skip them,
    matching the contract's ``len(hpol) < k`` guard)."""
    import os

    if k * rank_bits <= 62 and os.environ.get("NGSID_MINIMIZERS") != "python":
        from .. import native

        if native.available():
            return native.minimizers_native(seqs, k, w, rank_of, rank_bits)
    win = w - k + 1
    out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * len(seqs)
    fast_idx = [i for i, s in enumerate(seqs) if s.size - k + 1 > win]
    for s in range(0, len(fast_idx), _CHUNK):
        idx = fast_idx[s : s + _CHUNK]
        results = _batch_minimizers_padded([seqs[i] for i in idx], k, w,
                                           rank_of, rank_bits)
        for i, r in zip(idx, results):
            out[i] = r
    for i, s in enumerate(seqs):
        if out[i] is None:
            if s.size < k:
                out[i] = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
            else:
                out[i] = sequence_minimizers(s, k, w, rank_of, rank_bits)
    return out
