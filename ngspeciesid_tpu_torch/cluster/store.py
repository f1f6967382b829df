"""Columnar read store for the clustering engine.

All per-read derived quantities (homopolymer compression, compressed error
rates, minimizers, full-read poisson error rates, accession sort ranks) are
computed once, in vectorized batches, when the store is built — instead of
lazily per read like the reference (cluster.py:263-292).  The values are
bit-identical; only the evaluation schedule differs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.minimizers import alphabet_ranks, batch_minimizers
from ..utils.phred import PHRED_TO_P_CAPPED
from ..utils.seqs import hpol_compressed_qual_bytes, seq_bytes
from ..utils.phred import qual_bytes


class _LazyStrRows:
    """Sequence of str backed by uint8 rows, decoded per access.

    Strings live only at the I/O edge; store columns keep bytes and decode
    lazily for the few consumers that need text (output tables, dumps)."""

    __slots__ = ("_rows",)

    def __init__(self, rows: Sequence[np.ndarray]):
        self._rows = rows

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, i: int) -> str:
        return self._rows[i].tobytes().decode("ascii")

    def __iter__(self):
        for r in self._rows:
            yield r.tobytes().decode("ascii")


@dataclasses.dataclass
class ReadStore:
    """Immutable per-pass read data, indexed by read/cluster id."""

    ids: np.ndarray                 # global read/cluster ids (int64)
    accs: List[str]                 # accession WITH score suffix
    seqs: Sequence[str]             # lazily-decoded when built from bytes
    quals: Sequence[str]
    scores: np.ndarray              # float64
    batch_indices: np.ndarray       # previous batch index (merge rounds)
    seq_b: List[np.ndarray]         # uint8
    qual_b: List[np.ndarray]
    hpol: List[np.ndarray]          # hpol-compressed seq bytes
    error_rates: np.ndarray         # hpol-compressed error rate (float64)
    eidx: np.ndarray                # clamp/round error-rate index 0..14 (int8)
    full_err: np.ndarray            # capped poisson mean / len(seq), full read
    min_codes: List[np.ndarray]     # minimizer codes (int64)
    min_pos: List[np.ndarray]       # minimizer positions (int64)
    acc_rank: np.ndarray            # rank of acc in ascending lexicographic order
    id_to_row: dict                 # global id -> row index

    def row(self, read_id: int) -> int:
        return self.id_to_row[read_id]


def _hpol_error_rate(seq: np.ndarray, qual: np.ndarray) -> float:
    """Average capped error probability of the hpol-compressed quality string
    (reference cluster.py:279-291): per-run best quality char, then the
    count-weighted mean accumulated over ascending byte values."""
    qc = hpol_compressed_qual_bytes(seq, qual)
    counts = np.bincount(qc, minlength=128).astype(np.float64)
    return float(np.cumsum(counts * PHRED_TO_P_CAPPED)[-1] / qc.size)


def _full_error_rate(qual: np.ndarray) -> float:
    """Capped poisson mean over the full quality string / len — the per-read
    half of the block-align ``error_rate_sum`` (reference cluster.py:185-188)."""
    counts = np.bincount(qual, minlength=128).astype(np.float64)
    return float(np.cumsum(counts * PHRED_TO_P_CAPPED)[-1] / qual.size)


def build_store(
    read_array: Sequence[Tuple[int, int, str, str, str, float]],
    k: int,
    w: int,
    rank_of: Optional[np.ndarray] = None,
    rank_bits: Optional[int] = None,
) -> ReadStore:
    """Build the store from reference-shaped read tuples
    ``(id, batch_index, acc, seq, qual, score)``."""
    n = len(read_array)
    ids = np.array([r[0] for r in read_array], dtype=np.int64)
    batch_indices = np.array([r[1] for r in read_array], dtype=np.int64)
    accs = [r[2] for r in read_array]
    scores = np.array([r[5] for r in read_array], dtype=np.float64)

    # read tuples may carry seq/qual as str (reference-shaped) or as uint8
    # buffer views (the zero-decode loader); the store is byte-native either
    # way and exposes str columns lazily.
    if n and isinstance(read_array[0][3], np.ndarray):
        seq_b = [r[3] for r in read_array]
        qual_b = [r[4] for r in read_array]
        seqs: Sequence[str] = _LazyStrRows(seq_b)
        quals: Sequence[str] = _LazyStrRows(qual_b)
    else:
        seqs = [r[3] for r in read_array]
        quals = [r[4] for r in read_array]
        seq_b = [seq_bytes(s) for s in seqs]
        qual_b = [qual_bytes(q) for q in quals]
    # Homopolymer compression over the concatenated byte stream: one run-start
    # mask + one gather for the whole batch (identical values to per-read
    # hpol_compress_bytes; rows are views into the compacted flat array).
    if n:
        lens = np.fromiter((s.size for s in seq_b), np.int64, count=n)
        bounds = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=bounds[1:])
        flat = np.concatenate(seq_b) if n > 1 else seq_b[0]
        from .. import native
        nat = native.hpol_compress(flat, bounds) if native.available() else None
        if nat is not None:
            # two-pass OpenMP scan: the numpy mask + reduceat + boolean
            # gather triple below costs 1-4 s at 100k reads (10x at 1M,
            # and cold pages double it); the native scan is memory-speed.
            comp, cb = nat
        else:
            starts = np.empty(flat.size, dtype=bool)
            if flat.size:
                starts[0] = True
                np.not_equal(flat[1:], flat[:-1], out=starts[1:])
            nonempty = lens > 0
            starts[bounds[:-1][nonempty]] = True  # run never spans two reads
            comp = flat[starts]
            # per-read kept counts via reduceat over an int8 VIEW of the
            # bool mask with an int64 accumulator (the bool input takes
            # numpy's buffered casting path, several times slower)
            counts = np.zeros(n, dtype=np.int64)
            if comp.size:
                counts[nonempty] = np.add.reduceat(
                    starts.view(np.int8), bounds[:-1][nonempty],
                    dtype=np.int64)
            cb = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(counts, out=cb[1:])
        hpol = [comp[cb[i]:cb[i + 1]] for i in range(n)]
        hpol_flat: Optional[Tuple[np.ndarray, np.ndarray]] = (comp, cb)
    else:
        flat = np.zeros(0, dtype=np.uint8)
        hpol = []
        hpol_flat = None

    if rank_of is None:
        # alphabet detection: linear presence scan (np.unique would sort the
        # entire concatenated sequence data)
        present = np.zeros(256, dtype=bool)
        present[flat] = True
        rank_of, rank_bits = alphabet_ranks(
            np.flatnonzero(present).astype(np.uint8))
    if k * rank_bits > 63:
        raise NotImplementedError(
            f"k={k} with a {1 << rank_bits}-symbol alphabet exceeds 63-bit "
            "minimizer packing; supported k is up to "
            f"{63 // rank_bits} for this input."
        )

    from .. import native
    if native.available() and n:
        # one linear C pass per read (bit-identical accumulation order;
        # parity-tested in tests/test_native.py)
        error_rates, full_err = native.read_error_stats_native(
            seq_b, qual_b, PHRED_TO_P_CAPPED)
    else:
        error_rates = np.empty(n, dtype=np.float64)
        full_err = np.empty(n, dtype=np.float64)
        for i in range(n):
            error_rates[i] = _hpol_error_rate(seq_b[i], qual_b[i])
            full_err[i] = _full_error_rate(qual_b[i])
    # eidx = int(round(clamp_error_rate(e) * 100)) - 1, vectorized.
    # np.round(e, 2) equals python round(e, 2) except possibly when e*100
    # sits within float noise of a .5 tie; those few go through the scalar
    # path so the reference's table key (round-then-clamp, cluster.py:356-366)
    # is reproduced exactly.
    if n:
        e2 = np.round(error_rates, 2)
        frac = error_rates * 100.0
        near_tie = np.abs(frac - np.floor(frac) - 0.5) < 1e-9
        for i in np.flatnonzero(near_tie):
            e2[i] = round(float(error_rates[i]), 2)
        eidx = (np.clip(np.rint(e2 * 100.0), 1, 15) - 1).astype(np.int8)
    else:
        eidx = np.empty(0, dtype=np.int8)
    if hpol_flat is not None:
        # hpol rows are views into one compacted flat buffer (built above):
        # the native engine scans it in place, no staging copies
        from ..ops.minimizers import batch_minimizers_flat
        minims = batch_minimizers_flat(hpol_flat[0], hpol_flat[1],
                                       k, w, rank_of, rank_bits)
    else:
        minims = batch_minimizers(hpol, k, w, rank_of, rank_bits)
    min_codes = [m[0] for m in minims]
    min_pos = [m[1] for m in minims]

    # accession ranks: numpy unicode argsort == python str sort for the
    # ascii accessions fastq headers carry (code-point order either way)
    order = np.argsort(np.array(accs, dtype=np.str_), kind="stable")
    acc_rank = np.empty(n, dtype=np.int64)
    acc_rank[order] = np.arange(n)

    return ReadStore(
        ids=ids, accs=accs, seqs=seqs, quals=quals, scores=scores,
        batch_indices=batch_indices, seq_b=seq_b, qual_b=qual_b, hpol=hpol,
        error_rates=error_rates, eidx=eidx, full_err=full_err,
        min_codes=min_codes, min_pos=min_pos, acc_rank=acc_rank,
        id_to_row={int(r): i for i, r in enumerate(ids)},
    )
