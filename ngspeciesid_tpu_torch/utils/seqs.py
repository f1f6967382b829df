"""Byte-level sequence utilities (host side, numpy-vectorized).

Strings only exist at the I/O edge of the framework; everything here works on
uint8 ASCII arrays so it can feed the device encoders without re-parsing.
"""

from __future__ import annotations

import numpy as np

from .phred import PHRED_TO_P_CAPPED

# IUPAC-aware complement map (reference contract:
# modules/get_sorted_fastq_for_cluster.py:37, modules/consensus.py:78,
# modules/barcode_trimmer.py:10).  Identity for unlisted bytes.
_COMPLEMENT = np.arange(256, dtype=np.uint8)
for _a, _b in [
    ("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
    ("a", "t"), ("c", "g"), ("g", "c"), ("t", "a"),
    ("N", "N"), ("X", "X"), ("n", "n"),
    ("Y", "R"), ("R", "Y"), ("K", "M"), ("M", "K"),
    ("S", "S"), ("W", "W"), ("B", "V"), ("V", "B"),
    ("H", "D"), ("D", "H"),
    ("y", "r"), ("r", "y"), ("k", "m"), ("m", "k"),
    ("s", "s"), ("w", "w"), ("b", "v"), ("v", "b"),
    ("h", "d"), ("d", "h"),
]:
    _COMPLEMENT[ord(_a)] = ord(_b)


def seq_bytes(seq: str) -> np.ndarray:
    """Sequence string -> uint8 ASCII codes."""
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def bytes_to_str(arr: np.ndarray) -> str:
    return arr.tobytes().decode("ascii")


def reverse_complement_bytes(arr: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[arr[::-1]]


def reverse_complement(seq: str) -> str:
    """IUPAC-aware reverse complement (reference consensus.py:75-81)."""
    return bytes_to_str(reverse_complement_bytes(seq_bytes(seq)))


def hpol_run_starts(arr: np.ndarray) -> np.ndarray:
    """Boolean mask marking the first base of each homopolymer run."""
    if arr.size == 0:
        return np.zeros(0, dtype=bool)
    starts = np.empty(arr.size, dtype=bool)
    starts[0] = True
    np.not_equal(arr[1:], arr[:-1], out=starts[1:])
    return starts


def hpol_compress_bytes(arr: np.ndarray) -> np.ndarray:
    """Homopolymer-compress a byte sequence (one base per run).

    Matches ``''.join(ch for ch, _ in itertools.groupby(seq))``
    (reference cluster.py:265, get_sorted_fastq_for_cluster.py:58).
    """
    return arr[hpol_run_starts(arr)]


def hpol_compress(seq: str) -> str:
    return bytes_to_str(hpol_compress_bytes(seq_bytes(seq)))


def hpol_compressed_qual_bytes(seq: np.ndarray, qual: np.ndarray) -> np.ndarray:
    """Per-homopolymer-run best quality character.

    For each run the reference keeps the quality char with the LOWEST error
    probability under the capped phred table, resolving ties by the first
    occurrence in the run (``min(..., key=...)`` semantics, cluster.py:279-286).
    Returns the compressed quality byte array, aligned with
    :func:`hpol_compress_bytes` of ``seq``.
    """
    starts = hpol_run_starts(seq)
    run_id = np.cumsum(starts) - 1
    n_runs = run_id[-1] + 1 if seq.size else 0
    p = PHRED_TO_P_CAPPED[qual]
    # Stable lexsort by (run, p): first element of each sorted run group is the
    # first-occurring minimal-p char of that run — exactly Python min(key=...).
    order = np.lexsort((np.arange(seq.size), p, run_id))
    sorted_runs = run_id[order]
    first_of_run = np.ones(seq.size, dtype=bool)
    first_of_run[1:] = sorted_runs[1:] != sorted_runs[:-1]
    out = np.empty(n_runs, dtype=qual.dtype)
    out[sorted_runs[first_of_run]] = qual[order[first_of_run]]
    return out
