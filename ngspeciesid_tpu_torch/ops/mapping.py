"""Approximate read-to-center mapping: minimizer anchors + colinear chain.

TPU-native replacement for the reference's minimap2 usage (N4 in SURVEY.md):
``minimap2 -x map-ont center reads > paf`` feeds racon with PAF-level
overlaps (reference consensus.py:121).  At amplicon scale a full mapper is
unnecessary — the polish DP aligns reads exactly — but the mapping layer
exists for (a) the racon driver's per-iteration PAF observability contract
and (b) anchor-bounded windowing at depths where full DP is wasteful.

Pipeline per read: windowed minimizers of read and center (the clustering
engine's exact-semantics extractor, ops/minimizers.py) in both strands ->
shared-code anchor join (vectorized searchsorted) -> best colinear chain
(dense DP over anchors with an affine gap-difference penalty, the standard
minimap2 chaining recurrence at small n) -> PAF record.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .minimizers import alphabet_ranks, batch_minimizers
from ..utils.seqs import reverse_complement_bytes

#: minimizer parameters for mapping (the clustering k/w operate on
#: hpol-compressed reads, mapping uses raw sequence).  Denser than
#: map-ont (k=13, 5 k-mers per window) for sensitivity at ONT error
#: rates without hpol compression; w follows the engine's reference
#: semantics (window = w - k + 1 k-mer starts).
MAP_K = 13
MAP_W = 17
#: chaining: max gap-length difference between consecutive anchors
MAX_GAP = 500
#: minimum anchors in an accepted chain
MIN_CHAIN = 4


@dataclasses.dataclass
class Mapping:
    """One PAF row (minus the query name, supplied by the caller)."""

    q_len: int
    q_start: int
    q_end: int
    strand: str          # '+' | '-'
    t_len: int
    t_start: int
    t_end: int
    n_match: int         # chained anchor count * k (residue matches proxy)
    block_len: int
    mapq: int

    def paf_fields(self, q_name: str, t_name: str) -> List[str]:
        return [q_name, str(self.q_len), str(self.q_start), str(self.q_end),
                self.strand, t_name, str(self.t_len), str(self.t_start),
                str(self.t_end), str(self.n_match), str(self.block_len),
                str(self.mapq)]


def _minimizers(seq: np.ndarray, k: int, w: int,
                rank_of: np.ndarray, rank_bits: int):
    codes, pos = batch_minimizers([seq], k, w, rank_of, rank_bits)[0]
    return codes, pos


def _anchors(q_codes, q_pos, t_sorted, t_sort_pos) -> Tuple[np.ndarray, np.ndarray]:
    """All (query_pos, target_pos) pairs with equal minimizer codes.
    t_sorted / t_sort_pos: the center's codes sorted ascending and the
    matching positions (precomputed once per center)."""
    if q_codes.size == 0 or t_sorted.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lo = np.searchsorted(t_sorted, q_codes, side="left")
    hi = np.searchsorted(t_sorted, q_codes, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    q_idx = np.repeat(np.arange(q_codes.size), counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    flat = np.repeat(lo, counts) + within
    return q_pos[q_idx], t_sort_pos[flat]


def _chain(qa: np.ndarray, ta: np.ndarray, k: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Best colinear chain over anchors (minimap2-style scoring at dense-DP
    scale): score = chained seed coverage minus a log-ish gap penalty;
    returns (q_positions, t_positions) of the winning chain in order."""
    n = qa.size
    if n == 0:
        return None
    order = np.lexsort((qa, ta))
    qa, ta = qa[order], ta[order]
    if n >= 2:
        dq = np.diff(qa)
        dt = np.diff(ta)
        if ((dq > 0).all() and (dt > 0).all()
                and (np.abs(dq - dt) <= MAX_GAP).all()):
            # clean colinear anchor set (the common case for real reads):
            # chain every anchor and skip the per-anchor python DP below.
            # This is a deliberate heuristic shortcut, not an equivalence:
            # the DP can still prefer dropping an anchor when consecutive
            # diagonal offsets cancel (e.g. +g then -g makes the skip-gap
            # 0 while per-pair penalties stay ~0.5*log2(g+1) each), so
            # n_match / mapq / chain endpoints may differ in such corner
            # cases.  Acceptable for this mapper's role (PAF observability
            # + polish windows, SURVEY.md N4 "only approximate mapping").
            if n < MIN_CHAIN:
                return None
            return qa, ta
    score = np.full(n, float(k))
    parent = np.full(n, -1, dtype=np.int64)
    for i in range(1, n):
        dq = qa[i] - qa[:i]
        dt = ta[i] - ta[:i]
        ok = (dq > 0) & (dt > 0) & (np.abs(dq - dt) <= MAX_GAP)
        if not ok.any():
            continue
        gain = np.minimum(np.minimum(dq, dt), k).astype(np.float64)
        gap = np.abs(dq - dt).astype(np.float64)
        cand = score[:i] + gain - 0.5 * np.log2(gap + 1.0)
        cand = np.where(ok, cand, -np.inf)
        j = int(np.argmax(cand))
        if cand[j] > score[i]:
            score[i] = cand[j]
            parent[i] = j
    best = int(np.argmax(score))
    chain = []
    while best >= 0:
        chain.append(best)
        best = int(parent[best])
    chain.reverse()
    idx = np.array(chain, dtype=np.int64)
    if idx.size < MIN_CHAIN:
        return None
    return qa[idx], ta[idx]


def _chain_to_mapping(read_len: int, t_len: int, k: int, strand: str,
                      n_anchor: int, q0: int, q1: int,
                      t0: int, t1: int) -> Mapping:
    """Mapping record from chain endpoints — the single source of the
    endpoint +k extension, '-'-strand query-coordinate flip (PAF reports
    query coords on the original + strand), and block/n_match/mapq
    formulas, shared by the per-read and batched paths."""
    q_start, q_end = q0, q1 + k
    t_start, t_end = t0, t1 + k
    if strand == "-":
        q_start, q_end = read_len - q_end, read_len - q_start
    block = max(q_end - q_start, t_end - t_start)
    n_match = min(n_anchor * k, block)
    frac = n_match / block if block else 0.0
    mapq = int(min(60, 60 * frac * (n_anchor / (n_anchor + 10))))
    return Mapping(read_len, q_start, q_end, strand, t_len,
                   t_start, t_end, n_match, block, mapq)


def _map_one(
    read_len: int, t_len: int, k: int,
    fwd_min, rev_min,
    t_sorted: np.ndarray, t_sort_pos: np.ndarray,
) -> Optional[Mapping]:
    """Best chain over both orientations given precomputed minimizers."""
    best: Optional[Tuple[int, str, np.ndarray, np.ndarray]] = None
    for strand, (q_codes, q_pos) in (("+", fwd_min), ("-", rev_min)):
        qa, ta = _anchors(q_codes, q_pos, t_sorted, t_sort_pos)
        chain = _chain(qa, ta, k)
        if chain is None:
            continue
        cq, ct = chain
        if best is None or cq.size > best[0]:
            best = (int(cq.size), strand, cq, ct)
    if best is None:
        return None
    n_anchor, strand, cq, ct = best
    return _chain_to_mapping(read_len, t_len, k, strand, n_anchor,
                             int(cq[0]), int(cq[-1]), int(ct[0]), int(ct[-1]))


def map_read(
    read: np.ndarray, center: np.ndarray,
    rank_of: np.ndarray, rank_bits: int,
    k: int = MAP_K, w: int = MAP_W,
) -> Optional[Mapping]:
    """Map one read against the center in both orientations; best chain wins."""
    t_codes, t_pos = _minimizers(center, k, w, rank_of, rank_bits)
    t_sort = np.argsort(t_codes, kind="stable")
    fwd = _minimizers(read, k, w, rank_of, rank_bits)
    rev = _minimizers(reverse_complement_bytes(read), k, w, rank_of, rank_bits)
    return _map_one(read.size, center.size, k, fwd, rev,
                    t_codes[t_sort], t_pos[t_sort])


def _chain_batch(mins, t_sorted, t_sort_pos, n_reads: int, k: int):
    """Per-read best chains against one center, vectorized across reads.

    One concatenated searchsorted join + one global lexsort; the clean
    strictly-colinear fast path (the common case, see _chain) is decided
    per segment with vectorized diffs, and only non-clean segments fall
    back to the per-read python DP.  Returns per read either None or
    (n_anchor, q_start_anchor, q_end_anchor, t_start_anchor, t_end_anchor).
    Values are identical to mapping each read through _chain.
    """
    out: List[Optional[Tuple[int, int, int, int, int]]] = [None] * n_reads
    if t_sorted.size == 0:
        return out
    lens = np.fromiter((m[0].size for m in mins), np.int64, count=n_reads)
    codes_cat = (np.concatenate([m[0] for m in mins]) if lens.sum()
                 else np.zeros(0, np.int64))
    pos_cat = (np.concatenate([m[1] for m in mins]) if lens.sum()
               else np.zeros(0, np.int64))
    rid_cat = np.repeat(np.arange(n_reads, dtype=np.int64), lens)
    if codes_cat.size == 0:
        return out
    lo = np.searchsorted(t_sorted, codes_cat, side="left")
    hi = np.searchsorted(t_sorted, codes_cat, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return out
    rep = np.repeat(np.arange(codes_cat.size), counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    qa = pos_cat[rep]
    ta = t_sort_pos[np.repeat(lo, counts) + within]
    rid = rid_cat[rep]
    order = np.lexsort((qa, ta, rid))     # per read, (ta, qa) ascending
    rs, qs, ts = rid[order], qa[order], ta[order]
    first = np.empty(rs.size, bool)
    first[0] = True
    np.not_equal(rs[1:], rs[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    ends = np.append(starts[1:], rs.size)
    seg_rid = rs[starts]
    seg_n = ends - starts
    dq = np.diff(qs)
    dt = np.diff(ts)
    intra = ~first[1:]
    bad = intra & ((dq <= 0) | (dt <= 0) | (np.abs(dq - dt) > MAX_GAP))
    seg_bad = np.bincount(rs[1:][bad], minlength=n_reads)[seg_rid] > 0
    # a chain can never exceed its segment's anchor count, so segments under
    # MIN_CHAIN are None on every path (fast path and DP alike) — and they
    # are the bulk (unrelated reads sharing an accidental minimizer)
    for si in np.flatnonzero(seg_n >= MIN_CHAIN).tolist():
        r = int(seg_rid[si])
        s, e = int(starts[si]), int(ends[si])
        if not seg_bad[si]:
            out[r] = (int(seg_n[si]), int(qs[s]), int(qs[e - 1]),
                      int(ts[s]), int(ts[e - 1]))
        else:
            chain = _chain(qs[s:e], ts[s:e], k)
            if chain is not None:
                cq, ct = chain
                out[r] = (int(cq.size), int(cq[0]), int(cq[-1]),
                          int(ct[0]), int(ct[-1]))
    return out


def map_reads_to_center(
    center: np.ndarray, reads: Sequence[np.ndarray],
    k: int = MAP_K, w: int = MAP_W,
) -> List[Optional[Mapping]]:
    """Map every read: one center minimizer index, two batched minimizer
    passes (fw/rc), one vectorized anchor join + chain pass per strand."""
    if not reads:
        return []
    present = np.zeros(256, dtype=bool)
    present[center] = True
    for r in reads:
        present[r] = True
    rank_of, rank_bits = alphabet_ranks(np.flatnonzero(present).astype(np.uint8))
    t_codes, t_pos = _minimizers(center, k, w, rank_of, rank_bits)
    t_sort = np.argsort(t_codes, kind="stable")
    t_sorted, t_sort_pos = t_codes[t_sort], t_pos[t_sort]
    n = len(reads)
    fwd = batch_minimizers(list(reads), k, w, rank_of, rank_bits)
    rev = batch_minimizers([reverse_complement_bytes(r) for r in reads],
                           k, w, rank_of, rank_bits)
    res: List[Optional[Mapping]] = [None] * n
    best_n = [0] * n
    for strand, mins in (("+", fwd), ("-", rev)):
        chains = _chain_batch(mins, t_sorted, t_sort_pos, n, k)
        for i, ch in enumerate(chains):
            if ch is None or ch[0] <= best_n[i]:
                continue     # '+' wins ties, like _map_one's strict >
            n_anchor, q0, q1, t0, t1 = ch
            best_n[i] = n_anchor
            res[i] = _chain_to_mapping(reads[i].size, center.size, k, strand,
                                       n_anchor, q0, q1, t0, t1)
    return res


def write_paf(path: str, names: Sequence[str], mappings: Sequence[Optional[Mapping]],
              t_name: str) -> int:
    """Write PAF rows for mapped reads; returns the number written."""
    n = 0
    with open(path, "w") as f:
        for name, m in zip(names, mappings):
            if m is None:
                continue
            f.write("\t".join(m.paf_fields(name, t_name)) + "\n")
            n += 1
    return n
