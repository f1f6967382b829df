"""Wave-batched greedy clustering engine.

Re-designs the reference's strictly sequential read loop (reference
cluster.py:207-353) for batched device execution while preserving its exact
semantics:

  * Reads are processed in score order.  A read either joins an existing
    representative (mapping first, alignment fallback second) or becomes a
    new representative whose minimizers enter the database.
  * Because only NEW representatives mutate the database, a whole wave of W
    consecutive reads can be scored against a frozen database snapshot in
    one batched pass (minimizer join + mapping math vectorized; alignment
    fallback as one device DP batch).  At commit time the wave is replayed
    in order: a read that shares at least one minimizer with a representative
    created earlier in the same wave gets re-scored against the live
    database (its candidate set could differ from the speculative pass);
    all other decisions commit as computed.  With conflict replay the result
    is identical to sequential processing for every wave size — property-
    tested in tests/test_cluster_engine.py.

Decision semantics mirrored exactly (SURVEY.md C4/C5/C7/C8):
  * candidate order: (nr_hits, sum(hit positions), rep accession) descending
    (cluster.py:79);
  * mapping: gap spans between consecutive minimizer hits count as mapped
    iff p_err_kmer^gap >= min_prob_no_hits, where p_err_kmer comes from the
    empirical table clamped/rounded to a 15x15 grid; accept when
    mapped_ratio > mapped_threshold (cluster.py:67-127);
  * candidate pruning: stop when nm_hits < min_fraction * top_hits or
    < min_shared (cluster.py:88);
  * alignment fallback only when mapping failed and top_hits >= min_shared,
    over candidates tied at top_hits, with error-rate-tiered gap-open
    penalty and rolling-k match-window ratio >= aligned_threshold
    (cluster.py:172-205);
  * gap-pass probabilities use the same sequential float products
    (cumprod == reduce(mul)) so pass/fail flips bit-identically.
"""

from __future__ import annotations

import logging
import math
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..ops.align import block_stats_batch
from .store import ReadStore

logger = logging.getLogger(__name__)

#: Cumulative host walls of the engine's phases (seconds) — reset/read by
#: bench.py to decompose the cluster stage (decide pass vs alignment DP vs
#: conflict machinery).  Updated unconditionally; the overhead is two
#: perf_counter() calls per phase invocation (~300 per 100k pass).
PERF_COUNTERS = {"decide_s": 0.0, "align_s": 0.0, "conflict_s": 0.0}


def reset_perf_counters() -> None:
    for k in PERF_COUNTERS:
        PERF_COUNTERS[k] = 0.0


class MinimizerDB:
    """Minimizer postings: code -> ordered representative ids.

    Two-tier layout for O(1)-amortized growth under the wave engine's
    frequent snapshots: a sorted base (codes array + CSR postings) serving
    vectorized searchsorted joins, plus flat append buffers of recent
    (code, rep) insertions in strict chronological order.  The delta folds
    into the base only when it outgrows a fraction of it, so snapshot cost
    is amortized-logarithmic instead of a full rebuild per sub-round.
    Posting order (insertion order per code) is preserved across
    compactions — candidate ordering never depends on it (the sort key is
    (hits, sum_pos, acc), cluster.py:79), but determinism is kept anyway.
    """

    def __init__(self) -> None:
        # delta pairs in strict insertion order, amortized-growing buffers
        self._dcodes = np.zeros(256, dtype=np.int64)
        self._dposts = np.zeros(256, dtype=np.int64)
        self._dn = 0
        self._dset: set = set()    # distinct delta codes (membership only)
        self._n_codes = 0
        self._base_codes = np.zeros(0, dtype=np.int64)
        self._base_off = np.zeros(1, dtype=np.int64)
        self._base_posts = np.zeros(0, dtype=np.int64)
        self._version = 0          # bumped on insert; keys the delta snapshot
        self._delta_snap = None    # (version, d_codes, d_off, d_posts)

    def __len__(self) -> int:
        return self._n_codes

    def insert(self, codes: np.ndarray, rep_id: int) -> None:
        # one insert per representative; per-read duplicate codes collapse
        # (reference set semantics, cluster.py:329-334)
        self._version += 1
        base_codes = self._base_codes
        uniq = np.unique(codes)
        # one vectorized membership probe for the whole code set (a python
        # searchsorted per code dominated insert at 1M-read scale)
        if base_codes.size:
            loc = np.searchsorted(base_codes, uniq)
            locc = np.minimum(loc, base_codes.size - 1)
            in_base = base_codes[locc] == uniq
        else:
            in_base = np.zeros(uniq.size, dtype=bool)
        need = self._dn + uniq.size
        if need > self._dcodes.size:
            cap = self._dcodes.size
            while cap < need:
                cap *= 2
            self._dcodes = np.concatenate(
                [self._dcodes[: self._dn], np.zeros(cap - self._dn, np.int64)])
            self._dposts = np.concatenate(
                [self._dposts[: self._dn], np.zeros(cap - self._dn, np.int64)])
        self._dcodes[self._dn: need] = uniq
        self._dposts[self._dn: need] = rep_id
        self._dn = need
        dset = self._dset
        for c, known in zip(uniq.tolist(), in_base.tolist()):
            if c not in dset:
                dset.add(c)
                if not known:
                    self._n_codes += 1

    def _compact(self) -> None:
        if not self._dn:
            return
        # merge at posting level: stable sort by code keeps base postings
        # ahead of delta postings for shared codes, and delta pairs are in
        # strict insertion order, so per-code posting order is preserved
        base_lens = np.diff(self._base_off)
        post_codes = np.concatenate([
            np.repeat(self._base_codes, base_lens),
            self._dcodes[: self._dn]])
        post_vals = np.concatenate([self._base_posts,
                                    self._dposts[: self._dn]])
        order = np.argsort(post_codes, kind="stable")
        post_codes = post_codes[order]
        self._base_posts = post_vals[order]
        first = np.empty(post_codes.size, dtype=bool)
        if post_codes.size:
            first[0] = True
            first[1:] = post_codes[1:] != post_codes[:-1]
            starts = np.flatnonzero(first)
            self._base_codes = post_codes[starts]
            self._base_off = np.append(starts, post_codes.size).astype(np.int64)
        else:
            self._base_codes = np.zeros(0, np.int64)
            self._base_off = np.zeros(1, np.int64)
        self._dn = 0
        self._dset.clear()
        self._delta_snap = None
        self._n_codes = self._base_codes.size

    def snapshot(self):
        """Two CSR posting tables, (base_codes, base_off, base_posts,
        delta_codes, delta_off, delta_posts), for the batched join; folds
        the delta in when it has outgrown a fraction of the base.  The
        delta table is materialized here (sorted codes, insertion-ordered
        postings per code) from the flat pair buffers — no per-code python
        loops on the wave path."""
        if len(self._dset) > max(256, self._base_codes.size // 16):
            self._compact()
        if self._delta_snap is None or self._delta_snap[0] != self._version:
            n = self._dn
            if n:
                dc = self._dcodes[:n]
                order = np.argsort(dc, kind="stable")
                cs = dc[order]
                d_posts = self._dposts[:n][order]
                first = np.empty(n, dtype=bool)
                first[0] = True
                np.not_equal(cs[1:], cs[:-1], out=first[1:])
                starts = np.flatnonzero(first)
                d_codes = cs[starts]
                d_off = np.append(starts, n).astype(np.int64)
            else:
                d_codes = np.zeros(0, np.int64)
                d_off = np.zeros(1, np.int64)
                d_posts = np.zeros(0, np.int64)
            self._delta_snap = (self._version, d_codes, d_off, d_posts)
        _, d_codes, d_off, d_posts = self._delta_snap
        return (self._base_codes, self._base_off, self._base_posts,
                d_codes, d_off, d_posts)


class GapPassTable:
    """gmax per (eidx_read, eidx_rep): the largest gap length whose
    all-minimizers-erroneous probability still passes min_prob_no_hits.

    The probability of a gap of length g is the sequential product of g
    copies of ``p_err = 1.0 - p_emp``; cumprod reproduces the reference's
    reduce(mul) rounding exactly, and the product is monotone decreasing, so
    the pass test collapses to ``g <= gmax``.
    """

    def __init__(self, p_matrix: np.ndarray, min_prob_no_hits: float, max_gap: int):
        p_err = 1.0 - p_matrix  # (15, 15)
        max_gap = max(max_gap, 1)
        powers = np.cumprod(
            np.broadcast_to(p_err[:, :, None], p_err.shape + (max_gap,)), axis=2
        )
        self.gmax = np.count_nonzero(powers >= min_prob_no_hits, axis=2).astype(np.int64)
        # entries where even g = max_gap passes: no larger gap occurs in data
        self.has_entry = p_matrix > 0.0


class ClusterState:
    def __init__(self) -> None:
        self.clusters: Dict[int, List[str]] = {}
        self.alive: List[int] = []          # representative ids, creation order
        self.db = MinimizerDB()
        self.cluster_to_new: Dict[int, int] = {}


def _candidate_groups(
    store: ReadStore,
    rows: np.ndarray,
    snap,
    exclude_self: bool = True,
):
    """Batched minimizer join: hits of each wave read against the snapshot DB
    (two sorted CSR posting tables — compacted base + recent-insert delta —
    joined with vectorized searchsorted).

    Returns flat per-hit arrays grouped by (wave_read, rep): group start
    offsets, plus per-group read row, rep id, hit counts.
    """
    base_codes, base_off, base_posts, d_codes, d_off, d_posts = snap
    rid_list, midx_list, pos_list, code_list = [], [], [], []
    for wi, row in enumerate(rows):
        c = store.min_codes[row]
        rid_list.append(np.full(c.size, wi, dtype=np.int64))
        midx_list.append(np.arange(c.size, dtype=np.int64))
        pos_list.append(store.min_pos[row])
        code_list.append(c)
    if not rid_list:
        return None
    rid = np.concatenate(rid_list)
    midx = np.concatenate(midx_list)
    pos = np.concatenate(pos_list)
    code = np.concatenate(code_list)

    parts = []  # (rid_e, midx_e, pos_e, reps) fragments
    for codes_s, off, posts in ((base_codes, base_off, base_posts),
                                (d_codes, d_off, d_posts)):
        if not codes_s.size:
            continue
        loc = np.searchsorted(codes_s, code)
        loc_c = np.minimum(loc, codes_s.size - 1)
        found = codes_s[loc_c] == code
        b_rid, b_midx, b_pos, b_loc = rid[found], midx[found], pos[found], loc_c[found]
        if b_rid.size:
            counts = off[b_loc + 1] - off[b_loc]
            total = int(counts.sum())
            if total:
                starts = np.repeat(off[b_loc], counts)
                within = np.arange(total, dtype=np.int64) - np.repeat(
                    np.cumsum(counts) - counts, counts
                )
                parts.append((np.repeat(b_rid, counts), np.repeat(b_midx, counts),
                              np.repeat(b_pos, counts), posts[starts + within]))
    if not parts:
        return None
    rid_e = np.concatenate([p[0] for p in parts])
    midx_e = np.concatenate([p[1] for p in parts])
    pos_e = np.concatenate([p[2] for p in parts])
    reps = np.concatenate([p[3] for p in parts])
    if exclude_self:
        self_ids = store.ids[rows][rid_e]
        keep = reps != self_ids
        rid_e, midx_e, pos_e, reps = rid_e[keep], midx_e[keep], pos_e[keep], reps[keep]
    if rid_e.size == 0:
        return None
    order = np.lexsort((midx_e, reps, rid_e))
    rid_e, midx_e, pos_e, reps = rid_e[order], midx_e[order], pos_e[order], reps[order]
    grp_first = np.empty(rid_e.size, dtype=bool)
    grp_first[0] = True
    grp_first[1:] = (rid_e[1:] != rid_e[:-1]) | (reps[1:] != reps[:-1])
    seg_start = np.flatnonzero(grp_first)
    seg_end = np.append(seg_start[1:], rid_e.size)
    return {
        "rid": rid_e, "midx": midx_e, "pos": pos_e, "reps": reps,
        "seg_start": seg_start, "seg_end": seg_end,
        "g_rid": rid_e[seg_start], "g_rep": reps[seg_start],
        "g_count": seg_end - seg_start,
    }


def _mapping_stats(
    store: ReadStore, rows: np.ndarray, groups, gap_table: GapPassTable, cfg: Config
) -> Tuple[np.ndarray, np.ndarray]:
    """mapped_ratio and rep_mapped_ratio per candidate group (vectorized)."""
    midx, pos = groups["midx"], groups["pos"]
    seg_start, seg_end = groups["seg_start"], groups["seg_end"]
    g_rid, g_rep = groups["g_rid"], groups["g_rep"]
    n_seg = seg_start.size

    read_rows = rows[g_rid]
    rep_rows = np.array([store.id_to_row[int(r)] for r in g_rep], dtype=np.int64)
    gmax = gap_table.gmax[store.eidx[read_rows], store.eidx[rep_rows]]

    is_first = np.zeros(midx.size, dtype=bool)
    is_first[seg_start] = True
    prev_midx = np.empty_like(midx)
    prev_midx[1:] = midx[:-1]
    prev_midx[0] = 0
    prev_pos = np.empty_like(pos)
    prev_pos[1:] = pos[:-1]
    prev_pos[0] = 0
    gap = np.where(is_first, midx, midx - prev_midx - 1)
    contrib = np.where(is_first, pos, pos - prev_pos)
    seg_id = np.cumsum(is_first) - 1
    passes = gap <= gmax[seg_id]
    mapped = np.bincount(seg_id, weights=np.where(passes, contrib, 0), minlength=n_seg)

    # tail span: (L_comp - last_pos) if trailing gap passes
    last_idx = seg_end - 1
    n_min = np.array([store.min_codes[r].size for r in read_rows], dtype=np.int64)
    tail_gap = n_min - midx[last_idx] - 1
    tail_pass = tail_gap <= gmax
    l_comp = np.array([store.hpol[r].size for r in read_rows], dtype=np.float64)
    rep_len = np.array([store.hpol[r].size for r in rep_rows], dtype=np.float64)
    mapped = mapped + np.where(tail_pass, l_comp - pos[last_idx], 0.0)

    return mapped / l_comp, mapped / rep_len


def _sorted_candidate_order(store, groups, sum_pos):
    """Per-wave-read candidate ordering: (count, sum_pos, acc) descending."""
    rep_rows = np.array([store.id_to_row[int(r)] for r in groups["g_rep"]], dtype=np.int64)
    neg_rank = -store.acc_rank[rep_rows]
    order = np.lexsort((neg_rank, -sum_pos, -groups["g_count"], groups["g_rid"]))
    return order


def _addr_cols(store: ReadStore):
    """Per-store row address/length arrays for the pointer-row DP entry
    (lazy; rows are contiguous buffer views kept alive by the store)."""
    cols = getattr(store, "_addr_cols", None)
    if cols is None:
        n = len(store.seq_b)
        addrs = np.fromiter((r.ctypes.data for r in store.seq_b),
                            dtype=np.int64, count=n)
        lens = np.fromiter((r.size for r in store.seq_b),
                           dtype=np.int32, count=n)
        cols = (addrs, lens)
        store._addr_cols = cols
    return cols


def _native_cols(store: ReadStore):
    """Per-store columnar views for the native decision pass (cached)."""
    cols = getattr(store, "_native_cols", None)
    if cols is None:
        hpol_len = np.array([h.size for h in store.hpol], dtype=np.int64)
        max_id = int(store.ids.max()) if store.ids.size else 0
        row_of_id = np.zeros(max_id + 1, dtype=np.int64)
        row_of_id[store.ids] = np.arange(store.ids.size, dtype=np.int64)
        cols = (row_of_id, np.ascontiguousarray(store.eidx, dtype=np.int8),
                hpol_len, np.ascontiguousarray(store.acc_rank, dtype=np.int64))
        store._native_cols = cols
    return cols


def _decide_waves(
    store: ReadStore, rows: np.ndarray, snap, gap_table: GapPassTable, cfg: Config,
) -> List[Tuple[int, List[int]]]:
    """Speculative decisions for a wave of read rows against a frozen DB.

    Returns per read: (mapping_decision_rep_or_-1, nr_shared_top_hits,
    ordered list of alignment-fallback candidate rep ids).

    Dispatches to the fused C pass (native.decide_wave_native: join +
    mapping stats + candidate ordering + decision walk in one call,
    OpenMP over wave reads) unless NGSID_DECIDE=python; the numpy path
    below is the differential oracle (tests/test_cluster_engine.py)."""
    import os as _os

    if _os.environ.get("NGSID_DECIDE") != "python":
        from .. import native

        if native.available():
            return _decide_waves_native(store, rows, snap, gap_table, cfg)
    return _decide_waves_np(store, rows, snap, gap_table, cfg)


def _decide_waves_native(
    store: ReadStore, rows: np.ndarray, snap, gap_table: GapPassTable, cfg: Config,
) -> List[Tuple[int, List[int]]]:
    from .. import native

    n_wave = rows.size
    code_rows = [store.min_codes[r] for r in rows.tolist()]
    lens = np.fromiter((c.size for c in code_rows), dtype=np.int64, count=n_wave)
    roff = np.zeros(n_wave + 1, dtype=np.int64)
    np.cumsum(lens, out=roff[1:])
    codes = (np.concatenate(code_rows) if code_rows
             else np.zeros(0, dtype=np.int64))
    pos = (np.concatenate([store.min_pos[r] for r in rows.tolist()])
           if code_rows else np.zeros(0, dtype=np.int64))
    row_of_id, eidx, hpol_len, acc_rank = _native_cols(store)
    decisions, nr_shared, cand_off, cand_flat = native.decide_wave_native(
        np.ascontiguousarray(codes), np.ascontiguousarray(pos), roff,
        np.ascontiguousarray(rows, dtype=np.int64),
        np.ascontiguousarray(store.ids[rows], dtype=np.int64),
        snap, row_of_id, eidx, hpol_len, acc_rank,
        np.ascontiguousarray(gap_table.gmax, dtype=np.int64),
        cfg.min_shared, cfg.min_fraction, cfg.mapped_threshold,
        cfg.symmetric_map_align_thresholds,
    )
    return [
        (int(decisions[i]), int(nr_shared[i]),
         cand_flat[cand_off[i] : cand_off[i + 1]].tolist())
        for i in range(n_wave)
    ]


def _decide_waves_np(
    store: ReadStore, rows: np.ndarray, snap, gap_table: GapPassTable, cfg: Config,
) -> List[Tuple[int, List[int]]]:
    n_wave = rows.size
    results: List[Tuple[int, int, List[int]]] = [(-1, 0, []) for _ in range(n_wave)]
    groups = _candidate_groups(store, rows, snap)
    if groups is None:
        return results
    n_seg = groups["seg_start"].size
    seg_ids = np.repeat(np.arange(n_seg), groups["g_count"])
    sum_pos = np.bincount(seg_ids, weights=groups["pos"], minlength=n_seg)
    ratio, rep_ratio = _mapping_stats(store, rows, groups, gap_table, cfg)
    order = _sorted_candidate_order(store, groups, sum_pos)
    g_rid = groups["g_rid"][order]
    g_rep = groups["g_rep"][order]
    g_count = groups["g_count"][order]
    ratio = ratio[order]
    rep_ratio = rep_ratio[order]

    read_starts = np.flatnonzero(
        np.concatenate([[True], g_rid[1:] != g_rid[:-1]])
    )
    read_ends = np.append(read_starts[1:], g_rid.size)
    for s, e in zip(read_starts, read_ends):
        wi = int(g_rid[s])
        top_hits = int(g_count[s])
        nr_shared = top_hits
        decision = -1
        if top_hits >= cfg.min_shared:
            for t in range(s, e):
                nm = int(g_count[t])
                if nm < cfg.min_fraction * top_hits or nm < cfg.min_shared:
                    break
                if cfg.symmetric_map_align_thresholds:
                    ok = min(ratio[t], rep_ratio[t]) > cfg.mapped_threshold
                else:
                    ok = ratio[t] > cfg.mapped_threshold
                if ok:
                    decision = int(g_rep[t])
                    break
        aln_cands: List[int] = []
        if decision < 0 and nr_shared >= cfg.min_shared:
            for t in range(s, e):
                if int(g_count[t]) < top_hits:
                    break
                aln_cands.append(int(g_rep[t]))
        results[wi] = (decision, nr_shared, aln_cands)
    return results


class _WaveCodeCache:
    """Per-wave sorted view of the wave rows' minimizer codes.

    ``pending`` is always a SUFFIX of the wave, so one sort serves every
    sub-round; the conflict join then searches the (tiny) new-rep code
    set INTO the sorted wave codes instead of re-joining every pending
    code against the new-rep set each sub-round — new representatives
    are rare (a few per wave), so sub-round cost drops from
    O(pending_codes log new) to O(new_codes log pending_codes + hits).
    """

    __slots__ = ("code_rows", "lens", "starts", "owner_sorted", "flat_sorted")

    def __init__(self, store: ReadStore, wave_rows: List[int]):
        n = len(wave_rows)
        self.code_rows = [store.min_codes[r] for r in wave_rows]
        self.lens = np.fromiter((c.size for c in self.code_rows),
                                np.int64, count=n)
        self.starts = np.zeros(n + 1, np.int64)
        np.cumsum(self.lens, out=self.starts[1:])
        flat = (np.concatenate(self.code_rows) if n
                else np.zeros(0, np.int64))
        owner = np.repeat(np.arange(n, dtype=np.int64), self.lens)
        # quicksort: the conflict join only walks equal-code ranges with an
        # order-independent minimum-scatter, so stability buys nothing and
        # numpy's stable integer sort is ~4.5x slower at wave size
        order = np.argsort(flat)
        self.flat_sorted = flat[order]
        self.owner_sorted = owner[order]


def _conflict_positions(cache: _WaveCodeCache, start: int,
                        is_new: np.ndarray) -> np.ndarray:
    """Per pending row (= wave rows [start:]), the smallest pending-index
    of a would-be NEW representative sharing a minimizer code (n+1 when
    none).  The first index i whose conflict position is < i is exactly
    where the sequential walk breaks, and remaining rows with conflict
    position < break_at are exactly the stale set."""
    n = is_new.size
    BIG = np.int64(n + 1)
    out = np.full(n, BIG)
    new_idx = np.flatnonzero(is_new)
    if new_idx.size == 0:
        return out
    # (code, pending position) pairs of the new reps, min position per code
    parts = [cache.code_rows[start + int(p)] for p in new_idx]
    plens = np.fromiter((c.size for c in parts), np.int64,
                        count=len(parts))
    codes = np.concatenate(parts) if parts else np.zeros(0, np.int64)
    pos = np.repeat(new_idx, plens)
    # min-position-first per code: pack (code, pos) into one key so the
    # O(n log n) quicksort replaces numpy's ~4.5x-slower stable sort (the
    # first waves of a pass make every read a would-be new rep, so these
    # arrays reach wave size x codes-per-read)
    pos_bits = max(int(np.int64(n).item()).bit_length() + 1, 1)
    cmax = int(codes.max(initial=0))
    if cmax < (1 << (62 - pos_bits)):
        order = np.argsort((codes << pos_bits) | pos)
    else:                               # giant codes: keep the stable path
        order = np.argsort(codes, kind="stable")
    cs, ps = codes[order], pos[order]
    if cs.size == 0:
        return out
    firsts = np.empty(cs.size, bool)
    firsts[0] = True
    np.not_equal(cs[1:], cs[:-1], out=firsts[1:])
    uniq, upos = cs[firsts], ps[firsts]
    # all wave occurrences of the new-rep codes, restricted to the suffix
    lo = np.searchsorted(cache.flat_sorted, uniq, side="left")
    hi = np.searchsorted(cache.flat_sorted, uniq, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return out
    offs = (np.repeat(lo, counts)
            + np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts))
    m_owner = cache.owner_sorted[offs]
    m_pos = np.repeat(upos, counts)
    keep = m_owner >= start
    np.minimum.at(out, m_owner[keep] - start, m_pos[keep])
    return out


def _gap_open_tier(error_rate_sum: float) -> int:
    """Error-rate-tiered gap opening penalty (cluster.py:189-196)."""
    if error_rate_sum <= 0.01:
        return 5
    if error_rate_sum <= 0.04:
        return 4
    if error_rate_sum <= 0.1:
        return 3
    return 2


def _run_alignments(
    store: ReadStore,
    requests: List[Tuple[int, int, List[int]]],  # (wave_idx, read_row, [rep_ids])
    cfg: Config,
    cache: Optional[Dict[int, Tuple[float, float]]] = None,  # key = row * n_rows + rep_row
) -> Dict[int, int]:
    """Batched alignment fallback.  Returns {wave_idx: rep_id} for passes.

    All candidate pairs are aligned speculatively in one device batch; the
    sequential first-pass-wins rule is applied afterwards per read.  The
    per-pair ratios are pure functions of the pair, so sub-round rescoring
    reuses them through ``cache`` instead of re-running the DP."""
    if cache is None:
        cache = {}
    id_to_row = store.id_to_row
    full_err = store.full_err
    seq_b = store.seq_b
    n_rows = len(seq_b)
    k = cfg.k
    from ..ops.align import stats_backend_default
    backend = stats_backend_default()

    def _evaluate(todo_r1, todo_r2, todo_opens, todo_mids):
        """Batched (ratio, rep_ratio) for fresh pairs on the chosen backend;
        cuda sends every batch, however small, through the kernel."""
        if backend == "native":
            from .. import native
            addrs, lens = _addr_cols(store)
            r1 = np.fromiter(todo_r1, np.int64, count=len(todo_r1))
            r2 = np.fromiter(todo_r2, np.int64, count=len(todo_r2))
            return native.block_stats_ptr_native(
                addrs[r1], lens[r1], addrs[r2], lens[r2],
                np.asarray(todo_opens, np.int32),
                np.full(len(todo_r1), k, np.int32),
                np.asarray(todo_mids, np.int32),
                band=cfg.align_band)
        if backend in ("cuda", "torch"):
            from ..device import stats_device
            from ..ops.align_stats import sg_stats_pool_torch
            stats3 = sg_stats_pool_torch(
                seq_b, todo_r1, todo_r2,
                todo_opens, [k] * len(todo_r1), todo_mids,
                band=cfg.align_band, device=stats_device(backend))
            return [(r1, r2) for r1, r2, _ in stats3]
        return block_stats_batch(
            [(seq_b[a], seq_b[b]) for a, b in zip(todo_r1, todo_r2)],
            todo_opens, [k] * len(todo_r1), todo_mids,
            band=cfg.align_band, backend=backend)

    def _passes(st) -> bool:
        r1, r2 = st
        if cfg.symmetric_map_align_thresholds:
            return min(r1, r2) >= cfg.aligned_threshold
        return r1 >= cfg.aligned_threshold

    # Early-exit candidate rounds: the sequential walk stops at the FIRST
    # candidate whose alignment passes (reference cluster.py:181-203), and
    # most reads pass on candidate 1 — so align round r as one batch (every
    # unresolved read's r-th candidate) instead of speculatively aligning
    # every candidate of every read (~2.4x the DP work).  Per-pair results
    # are pure pair functions, so the cache stays valid across rounds and
    # sub-round rescoring.
    winners: Dict[int, int] = {}
    live: List[Tuple[int, int, List[int]]] = list(requests)
    rnd = 0
    while live:
        todo_opens: List[int] = []
        todo_mids: List[int] = []
        todo_keys: List[int] = []
        todo_r1: List[int] = []
        todo_r2: List[int] = []
        round_keys: List[int] = []
        for wi, row, rep_ids in live:
            rep = rep_ids[rnd]
            rrow = id_to_row[rep]
            # int key (row-pair flattened): tuple keys cost ~2x in dict
            # ops, which adds seconds over a 1M-read pass's ~1M pairs
            key = row * n_rows + rrow
            round_keys.append(key)
            if key not in cache:
                cache[key] = None        # claimed: scheduled this batch
                ers = float(full_err[row]) + float(full_err[rrow])
                todo_opens.append(_gap_open_tier(ers))
                todo_mids.append(math.floor((1.0 - ers) * k))
                todo_keys.append(key)
                todo_r1.append(row)
                todo_r2.append(rrow)
        if todo_keys:
            for key, st in zip(todo_keys,
                               _evaluate(todo_r1, todo_r2,
                                         todo_opens, todo_mids)):
                cache[key] = st
        survivors: List[Tuple[int, int, List[int]]] = []
        for (wi, row, rep_ids), key in zip(live, round_keys):
            if _passes(cache[key]):
                winners[wi] = int(store.ids[key % n_rows])
            elif len(rep_ids) > rnd + 1:
                survivors.append((wi, row, rep_ids))
        live = survivors
        rnd += 1
    return winners


def reads_to_clusters(
    store: ReadStore,
    clusters: Dict[int, List[str]],
    rep_rows: Sequence[int],
    gap_table: GapPassTable,
    cfg: Config,
    carried_db: Optional[MinimizerDB] = None,
    skip_batch_index: Optional[int] = None,
    new_batch_index: int = 1,
) -> Tuple[Dict[int, List[str]], List[int], MinimizerDB]:
    """One greedy clustering pass over ``rep_rows`` (already score-ordered).

    clusters: existing cluster membership (read id -> accession list); every
    read in the pass must have an entry (it starts as its own cluster).
    carried_db / skip_batch_index implement the merge-round skip logic
    (cluster.py:220-249): reads whose previous batch index equals
    ``skip_batch_index`` are already in the carried database and are not
    re-scored.

    Returns (clusters, surviving representative ids, minimizer db).
    """
    state = ClusterState()
    state.clusters = clusters
    state.db = carried_db if carried_db is not None else MinimizerDB()

    rows = np.asarray(rep_rows, dtype=np.int64)
    process_mask = np.ones(rows.size, dtype=bool)
    if skip_batch_index is not None:
        process_mask = store.batch_indices[rows] != skip_batch_index
    skipped_rows = rows[~process_mask]
    # skipped reads are already representatives inside carried_db
    alive: List[int] = [int(store.ids[r]) for r in skipped_rows]

    aln_cache: Dict[int, Tuple[float, float]] = {}  # key = row * n_rows + rep_row
    wave_size = cfg.wave_size
    if wave_size <= 0:
        # auto: the CUDA kernel takes large speculative waves (a pair is
        # 1-16 warps, and pairs share a block); the in-process engines
        # prefer smaller waves (less speculative DP on conflict replay).
        # 4096 is provisional, carried over from the reference until it is
        # measured on the card.
        from ..ops.align import stats_backend_default
        wave_size = 4096 if stats_backend_default() == "cuda" else 256
    wave_size = max(1, wave_size)
    to_process = rows[process_mask]
    n = to_process.size
    heartbeats = cfg.print_output if cfg.print_output else 0
    if heartbeats:
        logger.debug("Iteration\tNrClusters\tMinDbSize\tCurrReadId\tClusterSizes")

    hpol_lens = getattr(store, "_hpol_lens", None)
    if hpol_lens is None:
        hpol_lens = np.fromiter((h.size for h in store.hpol),
                                np.int64, count=len(store.hpol))
        store._hpol_lens = hpol_lens

    global_i = 0
    wave_start = 0
    while wave_start < n:
        wave_rows = to_process[wave_start : wave_start + wave_size]
        # Sub-round commit loop: score the whole pending wave against the
        # current DB snapshot in one batch, commit decisions in order until a
        # read shares a minimizer with a representative created *within this
        # sub-round* (its candidate set could differ from sequential
        # processing), then re-score the remainder against the updated DB.
        # Converges in ~(#new representatives whose minimizers collide with
        # later wave reads) sub-rounds; identical to sequential processing.
        pending = [int(r) for r in wave_rows]
        # Sub-rounds only re-score reads whose candidate set could have
        # changed: a read shares a minimizer with a representative created
        # after its last scoring (stale).  Clean reads keep their committed
        # decision — a representative can only become a candidate through a
        # shared minimizer, so no shared code means an identical candidate
        # set and an identical decision.
        final_dec: Dict[int, int] = {}
        stale = set(pending)
        wcache = _WaveCodeCache(store, pending)
        wave_n = len(pending)

        while pending:
            if stale:
                rows_list = [r for r in pending if r in stale]
                rows_arr = np.array(rows_list, dtype=np.int64)
                snap = state.db.snapshot()
                _t = _time.perf_counter()
                spec = _decide_waves(store, rows_arr, snap, gap_table, cfg)
                PERF_COUNTERS["decide_s"] += _time.perf_counter() - _t
                aln_requests = [
                    (wi, rows_list[wi], spec[wi][2])
                    for wi in range(len(spec))
                    if spec[wi][0] < 0 and spec[wi][2]
                ]
                _t = _time.perf_counter()
                aln_winners = _run_alignments(store, aln_requests, cfg, aln_cache)
                PERF_COUNTERS["align_s"] += _time.perf_counter() - _t
                for wi, row in enumerate(rows_list):
                    dec = spec[wi][0]
                    if dec < 0:
                        dec = aln_winners.get(wi, -1)
                    final_dec[row] = dec
                stale = set()

            # Vectorized conflict scan (the python set walk was O(wave^2)):
            # the walk breaks at the first row whose codes intersect an
            # EARLIER would-be new representative of this sub-round, and
            # the stale set is the remaining rows intersecting the
            # committed new representatives — both are pure functions of
            # (codes, decisions, order), computed in one sorted join.
            _t = _time.perf_counter()
            pend_arr = np.asarray(pending, dtype=np.int64)
            deg = hpol_lens[pend_arr] < cfg.k
            dec_arr = np.fromiter((final_dec[r] for r in pending),
                                  np.int64, count=len(pending))
            is_new = (dec_arr < 0) & ~deg
            conflict = _conflict_positions(
                wcache, wave_n - len(pending), is_new)
            PERF_COUNTERS["conflict_s"] += _time.perf_counter() - _t
            hits = np.flatnonzero(
                (conflict < np.arange(len(pending))) & ~deg)
            break_at = int(hits[0]) if hits.size else len(pending)

            for wi in range(break_at):
                row = pending[wi]
                rid = int(store.ids[row])
                if deg[wi]:
                    # degenerate read: unreachable via the CLI pipeline
                    # (stage 1 already filters these, get_sorted:134-135);
                    # kept as its own singleton cluster.
                    alive.append(rid)
                    global_i += 1
                    continue
                if (heartbeats and global_i % heartbeats == 0
                        and logger.isEnabledFor(logging.DEBUG)):
                    # reference cluster.py:253-259: sorted profile of the
                    # nontrivial (size > 1) cluster sizes so far.  Only
                    # computed when the debug line will actually be
                    # emitted: the profile rebuild is O(total joins) per
                    # heartbeat — ~50 s across a 1M-read pass
                    inv: Dict[int, List[int]] = {}
                    for src, dst in state.cluster_to_new.items():
                        inv.setdefault(dst, []).append(src)
                    sizes = sorted(
                        (1 + sum(len(state.clusters[c]) for c in members)
                         for members in inv.values()),
                        reverse=True)
                    sizes = [s for s in sizes if s > 1]
                    logger.debug(
                        "%d\t%d\t%d\t%s\t%s", global_i, len(sizes),
                        len(state.db),
                        "_".join(str(store.accs[row]).split("_")[:-1]),
                        ",".join(str(s) for s in sizes))
                global_i += 1
                dec = int(dec_arr[wi])
                if dec >= 0:
                    state.cluster_to_new[rid] = dec
                else:
                    state.db.insert(store.min_codes[row], rid)
                    alive.append(rid)
            if break_at < len(pending):
                rem_conflict = conflict[break_at:]
                pending = pending[break_at:]
                stale = {pending[t]
                         for t in np.flatnonzero(
                             rem_conflict < break_at).tolist()}
            else:
                pending = []
        wave_start += wave_size

    # final reassignment (cluster.py:337-345)
    for rid, new_id in state.cluster_to_new.items():
        state.clusters[new_id].extend(state.clusters[rid])
        del state.clusters[rid]

    # merge rounds: every read of the pass now carries this pass's batch
    # index (cluster.py:243-247, 273-277)
    store.batch_indices[rows] = new_batch_index

    return state.clusters, alive, state.db
