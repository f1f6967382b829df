"""Batched multiple-sequence consensus (spoa-class) and pileup polishing.

Port of ngspeciesid_tpu/ops/poa.py.  Its alignments run on the backend of
:func:`ngspeciesid_tpu_torch.device.stats_backend_default`: the draft's
batched read-vs-consensus DP through ``sg_align_batch``, and the polish
pileup through :func:`pileup_stats` (the moves kernel on ``cuda``).

Device-friendly replacement for the reference's spoa / racon / medaka
subprocesses (N3/N5/N6 in SURVEY.md; reference consensus.py:83-126).  Rather
than translating spoa's irregular partial-order DAG, consensus is built the
device-friendly way:

  1. draft pass — align each read (in cluster order, like spoa's sequential
     graph construction) against the running consensus with the batched
     semi-global DP (ops/align.py) and accumulate an MSA column profile:
     match/mismatch columns vote a base, deletions vote a gap, insertions
     open new columns.  The running consensus is the per-column majority.
     Reads of MANY clusters advance in lockstep, so every round is one
     device DP batch (all clusters' r-th reads vs their consensuses).
  2. polish pass(es) — re-align all reads against a fixed draft and take a
     (quality-weighted) plurality per column including insertion slots: the
     racon/medaka-class refinement.  Used by the polish drivers.

Only the aligned core of each read votes (terminal overhangs of the
semi-global alignment are trimmed), mirroring the local-alignment behaviour
of spoa ``-l 0`` and racon's windowed POA.

On amplicon-depth clusters one draft pass + one polish pass converges to the
template; tests/test_poa.py checks exact template recovery at ONT-like error
rates.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import align_moves, pileup
from .align import DIAG, LEFT, UP, sg_align_batch
from .align_stats import pair_rows
from ..device import stats_backend_default, stats_device
from ..spans import count, span
from ..utils.phred import PHRED_TO_P_CAPPED

_BASE_TO_COL = np.full(256, -1, dtype=np.int64)
for _i, _b in enumerate(b"ACGT"):
    _BASE_TO_COL[_b] = _i
_COL_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)

GAP_COL = 4
_N_SYM = 5  # A C G T gap

# POA alignment parameters: cheap affine gaps suit noisy long reads (the
# reference invokes spoa with a reduced gap penalty, consensus.py:87).
POA_MATCH, POA_MISMATCH, POA_OPEN, POA_EXT = 2, -2, 2, 1
#: DP band half-width for read-vs-consensus alignments (same-template pairs,
#: drift far below this at any amplicon indel rate)
POA_BAND = 150


def trim_to_aligned(moves: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Strip terminal overhangs: returns (core_moves, cons_skip, read_skip)
    where the skips count consensus/read positions consumed before the first
    match/mismatch column."""
    diag_idx = np.flatnonzero(moves == DIAG)
    if diag_idx.size == 0:
        return moves[:0], 0, 0
    lo, hi = int(diag_idx[0]), int(diag_idx[-1]) + 1
    head = moves[:lo]
    cons_skip = int(np.count_nonzero(head == UP))
    read_skip = int(np.count_nonzero(head == LEFT))
    return moves[lo:hi], cons_skip, read_skip


class _Profile:
    """Mutable MSA column profile for one cluster."""

    __slots__ = ("counts", "n_reads")

    def __init__(self, first_read: np.ndarray):
        self.counts = np.zeros((first_read.size, _N_SYM), dtype=np.float64)
        cols = _BASE_TO_COL[first_read]
        valid = cols >= 0
        self.counts[np.flatnonzero(valid), cols[valid]] = 1.0
        self.n_reads = 1

    def consensus_and_map(self) -> Tuple[np.ndarray, np.ndarray]:
        """Current majority consensus and its profile-column indices.

        A column emits its most frequent base unless the gap count strictly
        exceeds it (base wins ties); ties among bases pick the smallest.
        """
        counts = self.counts
        base_best = np.argmax(counts[:, :4], axis=1)
        base_cnt = counts[np.arange(counts.shape[0]), base_best]
        keep = base_cnt >= counts[:, GAP_COL]
        cols = np.flatnonzero(keep)
        return _COL_TO_BASE[base_best[cols]], cols

    def consensus(self) -> np.ndarray:
        return self.consensus_and_map()[0]

    def add_aligned(self, read: np.ndarray, moves: np.ndarray,
                    cons_cols: np.ndarray) -> None:
        """Fold an alignment (consensus = s1, read = s2) into the profile.

        cons_cols maps consensus positions -> profile column indices.
        Insertions first try to match an existing suppressed column (one the
        current consensus dropped as gap-majority) carrying the same base in
        the spanned interval — this is what makes repeated insertions
        accumulate support, like branches in a real PO graph.  Unmatched
        insertions create new columns back-filled with gap counts.  All
        suppressed columns inside the read's aligned span that the read did
        not use receive a gap vote; terminal overhangs do not vote.
        """
        core, cons_skip, read_skip = trim_to_aligned(moves)
        if core.size == 0:
            self.n_reads += 1
            return
        n_cols = self.counts.shape[0]
        # Vectorized walk (VERDICT r3 item 5): DIAG/UP commits are computed
        # with cumulative indices in one shot — every consensus position is
        # consumed exactly once, so the scatter targets are disjoint — and
        # only the insertion steps (indel-rate-sized tail) run the
        # sequential suppressed-column matching below.  Accumulation values
        # are identical to the per-move walk.
        is_commit = core != LEFT            # DIAG or UP: consumes a cons pos
        is_diag = core == DIAG
        is_left = ~is_commit
        ci_at = cons_skip + np.cumsum(is_commit) - 1   # ci value at commits
        ri_at = read_skip + np.cumsum(core != UP) - 1  # ri value at DIAG/LEFT
        add_sym = np.full(n_cols, -1, dtype=np.int64)
        d_cols = cons_cols[ci_at[is_diag]]
        add_sym[d_cols] = _BASE_TO_COL[read[ri_at[is_diag]]]
        u_mask = is_commit & ~is_diag
        add_sym[cons_cols[ci_at[u_mask]]] = GAP_COL
        lo_col = int(cons_cols[cons_skip])  # columns < this are outside span
        # interval_ptr base at each step: (last commit's profile col) + 1,
        # or lo_col before the first commit.  Commit cols strictly increase
        # along the alignment, so a running max reconstructs the pointer.
        commit_cols_all = np.where(is_commit, cons_cols[ci_at] + 1, lo_col)
        ptr_base = np.maximum.accumulate(commit_cols_all)
        # trim_to_aligned guarantees core ends with a DIAG commit, so the
        # walk's final interval_ptr is always (last commit col) + 1
        hi_col = int(cons_cols[ci_at[is_commit]][-1]) + 1
        new_cols: List[Tuple[int, int]] = []  # (insert_before_profile_col, base)
        left_idx = np.flatnonzero(is_left)
        if left_idx.size:
            counts = self.counts
            ci_left = cons_skip + np.cumsum(is_commit)[left_idx]
            limits = np.where(ci_left < cons_cols.size,
                              cons_cols[np.minimum(ci_left, cons_cols.size - 1)],
                              n_cols)
            bases_col = _BASE_TO_COL[read[ri_at[left_idx]]]
            bases_raw = read[ri_at[left_idx]]
            cur_base = -1      # ptr_base of the gap being walked
            cur_ptr = 0
            for t in range(left_idx.size):
                bp = int(ptr_base[left_idx[t]])
                if bp != cur_base:          # entered a new inter-commit gap
                    cur_base = bp
                    cur_ptr = bp
                limit = int(limits[t])
                base_col = int(bases_col[t])
                matched = -1
                p = cur_ptr
                while p < limit:
                    if add_sym[p] < 0 and base_col >= 0 and counts[p, base_col] > 0:
                        matched = p
                        break
                    p += 1
                if matched >= 0:
                    add_sym[matched] = base_col
                    cur_ptr = matched + 1
                else:
                    new_cols.append((limit, int(bases_raw[t])))
        # gap votes for spanned suppressed columns the read did not use
        span = np.arange(lo_col, min(hi_col, n_cols))
        unused = span[add_sym[span] < 0]
        add_sym[unused] = GAP_COL
        rows = np.flatnonzero(add_sym >= 0)
        self.counts[rows, add_sym[rows]] += 1.0
        if new_cols:
            self._insert_columns(new_cols)
        self.n_reads += 1

    def _insert_columns(self, new_cols: List[Tuple[int, int]]) -> None:
        old = self.counts
        L = old.shape[0]
        befores = np.array([c[0] for c in new_cols], dtype=np.int64)
        ins_count = np.zeros(L + 1, dtype=np.int64)
        np.add.at(ins_count, befores, 1)
        cum_incl = np.cumsum(ins_count)          # inserts with before <= b
        out = np.zeros((L + len(new_cols), _N_SYM), dtype=np.float64)
        out[np.arange(L) + cum_incl[:L]] = old   # old col i -> i + #inserts<=i
        gap_base = float(self.n_reads)           # earlier reads gap these columns
        seen: Dict[int, int] = {}
        for before, base in new_cols:            # read order = left to right
            o = seen.get(before, 0)
            seen[before] = o + 1
            dest = before + (cum_incl[before] - ins_count[before]) + o
            col = _BASE_TO_COL[base]
            if col >= 0:
                out[dest, col] += 1.0
            out[dest, GAP_COL] += gap_base
        self.counts = out


def msa_consensus_batch(
    clusters_reads: Sequence[Sequence[np.ndarray]],
    max_reads: int = -1,
) -> List[np.ndarray]:
    """Draft consensus per cluster; reads of all clusters advance in lockstep
    so each round is a single batched device alignment."""
    profiles: List[Optional[_Profile]] = []
    capped: List[List[np.ndarray]] = []
    for reads in clusters_reads:
        reads = list(reads if max_reads < 0 else reads[:max_reads])
        capped.append(reads)
        profiles.append(_Profile(reads[0]) if reads else None)
    max_n = max((len(r) for r in capped), default=0)
    for r in range(1, max_n):
        todo = [ci for ci, reads in enumerate(capped) if len(reads) > r]
        if not todo:
            break
        pairs = []
        cons_maps = []
        with span("poa.fold"):
            for ci in todo:
                cons, cols = profiles[ci].consensus_and_map()
                pairs.append((cons, capped[ci][r]))
                cons_maps.append(cols)
        moves = sg_align_batch(pairs, [POA_OPEN] * len(pairs),
                               match=POA_MATCH, mismatch=POA_MISMATCH,
                               gap_ext=POA_EXT, band=POA_BAND)
        with span("poa.fold"):
            for ci, mv, cols in zip(todo, moves, cons_maps):
                profiles[ci].add_aligned(capped[ci][r], mv, cols)
    return [p.consensus() if p is not None else np.zeros(0, np.uint8)
            for p in profiles]


# ---------------------------------------------------------------------------
# pileup polish (racon/medaka-class refinement)
# ---------------------------------------------------------------------------

class PileupStats:
    """Per-position pileup statistics of reads aligned against a center."""

    __slots__ = ("votes", "qvotes", "coverage", "ins_votes", "ins_open")

    def __init__(self, L: int):
        self.votes = np.zeros((L, _N_SYM), dtype=np.float64)     # unit counts
        self.qvotes = np.zeros((L, _N_SYM), dtype=np.float64)    # qual-weighted
        self.coverage = np.zeros(L + 1, dtype=np.float64)        # slot coverage
        self.ins_votes: List[Dict[bytes, float]] = [dict() for _ in range(L + 1)]
        self.ins_open = np.zeros(L + 1, dtype=np.float64)


def _pileup_stats_native(
    center: np.ndarray,
    reads: Sequence[np.ndarray],
    quals: Optional[Sequence[np.ndarray]],
    windows: Optional[np.ndarray] = None,
) -> PileupStats:
    """Fused DP + accumulation in the C engine; only insertion events (the
    indel-rate-sized tail) fold into dicts on the host.  Bit-identical to
    the Python walk (sequential read-order accumulation inside the engine;
    parity-tested in tests/test_poa.py)."""
    from .. import native

    st = PileupStats(center.size)
    weights = (
        [(1.0 - PHRED_TO_P_CAPPED[q]) for q in quals] if quals is not None else None
    )
    votes, qvotes, coverage, ev_pos, ev_w, ev_len, ev_bytes = native.pileup_native(
        center, list(reads), weights,
        POA_MATCH, POA_MISMATCH, POA_OPEN, POA_EXT, POA_BAND,
        windows=windows,
    )
    st.votes, st.qvotes, st.coverage = votes, qvotes, coverage
    _fold_events(st, ev_pos, ev_w, ev_len, ev_bytes)
    return st


def _fold_events(st: PileupStats, ev_pos: np.ndarray, ev_w: np.ndarray,
                 ev_len: np.ndarray, ev_bytes: np.ndarray) -> None:
    """Fold insertion events, given in the walk's order, into
    ``st.ins_votes`` and ``st.ins_open``: the same keys, values, and key
    order in each dict as the walk's ``add_ins`` one event at a time.

    Vectorized (the per-event python loop cost ~5 s at 200 polished
    centers — ~4.5M insertion events): events are grouped by (pos, inserted
    string) with a packed int64 key, each group's weights summed with a
    STABLE order so the per-key float accumulation order matches the
    sequential walk bit-for-bit (parity-tested), and the python dicts are
    touched once per distinct (pos, string), in the order of each group's
    first event.  Events too long to pack are added one by one."""
    n_ev = int(ev_pos.size)
    if n_ev == 0:
        return
    ins_votes, ins_open = st.ins_votes, st.ins_open
    eb = ev_bytes.tobytes()
    off_arr = np.zeros(n_ev + 1, np.int64)
    np.cumsum(ev_len, out=off_arr[1:])
    ins_open += np.bincount(ev_pos, minlength=ins_open.size).astype(np.float64)
    present = np.unique(ev_bytes)
    sbits = max(1, int(present.size).bit_length())  # symbols mapped to 1..n
    lut = np.zeros(256, np.int64)
    lut[present] = np.arange(1, present.size + 1)
    pos_bits = int(ins_open.size).bit_length()
    max_pack = (62 - pos_bits) // sbits
    ln_max = int(ev_len.max())
    small = ev_len <= max_pack
    sym = lut[ev_bytes]
    key = ev_pos.astype(np.int64)
    for j in range(min(ln_max, max_pack)):
        bj = np.where(ev_len > j, sym[np.minimum(off_arr[:-1] + j,
                                                 sym.size - 1)], 0)
        key = (key << sbits) | bj
    idx_small = np.flatnonzero(small)
    firsts = np.zeros(0, np.int64)
    gw: List[float] = []
    if idx_small.size:
        ks = key[idx_small]
        sort = np.argsort(ks, kind="stable")
        ks_sorted = ks[sort]
        gfirst = np.empty(idx_small.size, bool)
        gfirst[0] = True
        np.not_equal(ks_sorted[1:], ks_sorted[:-1], out=gfirst[1:])
        starts = np.flatnonzero(gfirst)
        # group weights via bincount over the ORIGINAL event order:
        # bincount accumulates its input sequentially, so each group's sum
        # reproduces the python walk's per-key float accumulation
        # bit-for-bit (reduceat would not — it sums pairwise)
        ginv = np.empty(idx_small.size, np.int64)
        ginv[sort] = np.cumsum(gfirst) - 1
        gw = np.bincount(ginv, weights=ev_w[idx_small],
                         minlength=starts.size).tolist()
        firsts = idx_small[sort[starts]]   # stable: each group's first event
    # groups and long events in the order of their (first) event
    items = np.concatenate([firsts, np.flatnonzero(~small)])
    n_groups = firsts.size
    order = np.argsort(items, kind="stable")
    es = items[order]
    for t, p, o, n, w in zip(order.tolist(), ev_pos[es].tolist(),
                             off_arr[es].tolist(), ev_len[es].tolist(),
                             ev_w[es].tolist()):
        d = ins_votes[p]
        k = eb[o: o + n]
        if t < n_groups:
            d[k] = gw[t]
        else:
            d[k] = d.get(k, 0.0) + w


def _pileup_stats_device(
    center: np.ndarray,
    reads: Sequence[np.ndarray],
    quals: Optional[Sequence[np.ndarray]],
    windows: Optional[np.ndarray],
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    device,
) -> PileupStats:
    """The moves DP of ``pairs`` (each read against the center or its
    window) and the accumulation on ``device``: the moves kernel's
    traced paths stay there (the chunks of
    ``align_moves.sg_moves_pool_torch``'s result, whose moves are never
    read here) and ``ops/pileup.py`` (its kernel on a CUDA device, its
    plain version on the CPU) turns them into the column counts and
    events; only those cross to the host.  Bit-identical to :func:`_walk`
    over the full-span moves of the same DP."""
    seqs, rows1, rows2 = pair_rows(pairs)
    moves = align_moves.sg_moves_pool_torch(
        seqs, rows1, rows2, [POA_OPEN] * len(pairs), match=POA_MATCH,
        mismatch=POA_MISMATCH, gap_ext=POA_EXT, band=POA_BAND, device=device)
    count("poa.reads", len(reads))
    with span("poa.walk"):
        st = pileup_from_chunks(center.size, reads, quals, windows,
                                moves.buf, moves.chunks)
    count("poa.walk_card", len(reads))
    return st


def pileup_from_chunks(L: int, reads: Sequence[np.ndarray],
                       quals: Optional[Sequence[np.ndarray]],
                       windows: Optional[np.ndarray], pool,
                       chunks: List) -> PileupStats:
    """The PileupStats of ``reads`` against a center of length L from the
    launched moves chunks of their pairs and the pool tensor they read
    (``ops/pileup.accumulate``): the column counts as they come back, the
    events folded by :func:`_fold_events`."""
    st = PileupStats(L)
    stats, events = pileup.accumulate(L, reads, quals, windows, pool, chunks)
    st.votes = stats[: 5 * L].reshape(L, _N_SYM)
    st.qvotes = stats[5 * L: 10 * L].reshape(L, _N_SYM)
    st.coverage = stats[10 * L: 11 * L + 1]
    _fold_events(st, *pileup.event_arrays(reads, quals, events))
    return st


def pileup_stats(
    center: np.ndarray,
    reads: Sequence[np.ndarray],
    quals: Optional[Sequence[np.ndarray]] = None,
    windows: Optional[np.ndarray] = None,
) -> PileupStats:
    """Align reads to the fixed center (banded, batched) and accumulate both
    unit and quality-weighted per-column counts plus insertion events.

    windows: optional (B, 2) per-read center spans [lo, hi): the DP runs
    only against that slice (anchor-bounded polish for long centers) with
    votes reported in center coordinates.  Terminal-extension events only
    fire at true center termini (lo == 0 / hi == L).

    ``native`` runs the fused DP + accumulation of the C++ engine; ``cuda``
    and ``torch`` the moves kernel (or its plain version) and the pileup
    kernel of ``ops/pileup.py`` (or its plain version) on its traced paths;
    ``host`` the numpy mirror followed by the accumulation walk below
    (:func:`_walk`).  Outputs are bit-identical whenever the optimal paths
    stay inside the band (the polish-window contract)."""
    L = center.size
    st = PileupStats(L)
    if not reads or L == 0:
        return st
    backend = stats_backend_default()
    if backend == "native":
        return _pileup_stats_native(center, reads, quals, windows)
    if windows is None:
        pairs = [(center, r) for r in reads]
    else:
        pairs = [(center[windows[i, 0]:windows[i, 1]], r)
                 for i, r in enumerate(reads)]
    if backend in ("cuda", "torch"):
        return _pileup_stats_device(center, reads, quals, windows, pairs,
                                    stats_device(backend))
    moves_all = sg_align_batch(pairs, [POA_OPEN] * len(pairs),
                               match=POA_MATCH, mismatch=POA_MISMATCH,
                               gap_ext=POA_EXT, backend=backend,
                               band=POA_BAND)
    count("poa.reads", len(reads))
    with span("poa.walk"):
        _walk(st, center, reads, quals, windows, moves_all)
    return st


def _walk(st: PileupStats, center, reads, quals, windows, moves_all) -> None:
    """Accumulate each read's moves against the center into ``st``: the
    ``host`` backend's pileup, and the oracle ``ops/pileup.py`` is held
    to."""
    L = center.size
    votes, qvotes = st.votes, st.qvotes
    ins_votes, ins_open = st.ins_votes, st.ins_open
    for ri_read, moves in enumerate(moves_all):
        read = reads[ri_read]
        wl = int(windows[ri_read, 0]) if windows is not None else 0
        Lw = (int(windows[ri_read, 1]) - wl) if windows is not None else L
        head_terminal = wl == 0
        tail_terminal = wl + Lw == L
        w = (1.0 - PHRED_TO_P_CAPPED[quals[ri_read]]) if quals is not None else None
        core, ci0, ri0 = trim_to_aligned(moves)
        if core.size == 0:
            continue

        def add_ins(pos, r_lo, r_hi):
            """Fold read bases [r_lo, r_hi) as one insertion event at pos."""
            key = read[r_lo:r_hi].tobytes()
            ww = (float(w[r_lo:r_hi].sum()) if w is not None
                  else float(r_hi - r_lo))
            d = ins_votes[pos]
            d[key] = d.get(key, 0.0) + ww / (r_hi - r_lo)
            ins_open[pos] += 1.0

        # Terminal extension: a read whose alignment starts at center
        # position 0 but has unaligned head bases extends the center leftward
        # (symmetrically at the tail below).  Without this, a truncated
        # center can never be repaired past its own ends — spoa's graph
        # consensus (reference consensus.py:83-92) has no such cap.
        if head_terminal and ci0 == 0 and ri0 > 0:
            add_ins(0, 0, ri0)

        # Vectorized accumulation (VERDICT r3 item 5): commits are scattered
        # in one shot (each center position is consumed at most once per
        # read, so targets are disjoint); only insertion RUNS (indel-rate-
        # sized) loop below.  Values are identical to the per-move walk.
        is_commit = core != LEFT
        is_diag = core == DIAG
        ci_at = ci0 + np.cumsum(is_commit) - 1   # ci value at commit steps
        ri_at = ri0 + np.cumsum(core != UP) - 1  # ri value at DIAG/LEFT steps
        d_pos = wl + ci_at[is_diag]
        d_ri = ri_at[is_diag]
        b = _BASE_TO_COL[read[d_ri]]
        bv = b >= 0
        votes[d_pos[bv], b[bv]] += 1.0
        qvotes[d_pos[bv], b[bv]] += w[d_ri[bv]] if w is not None else 1.0
        u_pos = wl + ci_at[is_commit & ~is_diag]
        votes[u_pos, GAP_COL] += 1.0
        qvotes[u_pos, GAP_COL] += 1.0
        # insertion runs: maximal stretches of LEFT flush at the ci of the
        # following commit (trim guarantees core ends with a DIAG, so every
        # run has one)
        left_idx = np.flatnonzero(~is_commit)
        n_commits = int(is_commit.sum())
        if left_idx.size:
            run_end = np.flatnonzero(
                np.concatenate([np.diff(left_idx) > 1, [True]]))
            run_start = np.concatenate([[0], run_end[:-1] + 1])
            for s, e in zip(run_start.tolist(), run_end.tolist()):
                i_lo, i_hi = int(left_idx[s]), int(left_idx[e])
                # flush position: ci value at the next commit step (= the
                # ci this run's pending sat before in the sequential walk)
                pos = wl + int(ci_at[i_hi]) + 1
                add_ins(pos, int(ri_at[i_lo]), int(ri_at[i_hi]) + 1)
        ci_end = ci0 + n_commits
        if tail_terminal and ci_end == Lw:
            r_done = int(ri_at[-1]) + 1 if core.size else ri0
            if r_done < read.size:
                add_ins(L, r_done, read.size)
        st.coverage[wl + ci0 : wl + ci_end + 1] += 1.0


#: Anchor-bounded polish gate: centers at least this long compute mapper
#: windows so each read's DP covers only its span (+pad) instead of the
#: whole center.  Amplicon-size centers (reads ~ center) are unaffected —
#: windowing would cover the full center anyway, so behaviour is unchanged.
AUTO_WINDOW_MIN_CENTER = 2000
#: minimum supporting reads for a structural edit (insertion / deletion of
#: draft bases) during polishing; plurality alone suffices for substitutions
MIN_STRUCT_EVIDENCE = 2
#: window padding beyond the chained anchor span + unaligned query flanks.
#: Deliberately small: the window must stay read-sized so the banded DP's
#: scaled diagonal has slope ~1 over the true alignment — over-padding
#: shrinks the slope and pushes the path out of the band near the edges.
WINDOW_PAD = 50


def orient_reads(
    center: np.ndarray,
    reads: Sequence[np.ndarray],
    quals: Optional[Sequence[np.ndarray]] = None,
):
    """Flip reads whose best center mapping is reverse-strand.

    The reference polishes through minimap2 + racon/medaka, which handle
    strands natively (consensus.py:121); RC-merged centers pool reads of
    both orientations (consensus.py:167-180), so without orientation half
    of a merged cluster's reads align as noise and vote nothing.
    Returns (reads, quals, mappings) with quals None when not given."""
    from .mapping import map_reads_to_center
    from ..utils.seqs import reverse_complement_bytes

    with span("poa.orient"):
        mappings = map_reads_to_center(center, reads)
        out_s: List[np.ndarray] = []
        out_q: Optional[List[np.ndarray]] = [] if quals is not None else None
        for i, m in enumerate(mappings):
            if m is not None and m.strand == "-":
                out_s.append(reverse_complement_bytes(reads[i]))
                if out_q is not None:
                    out_q.append(quals[i][::-1])
            else:
                out_s.append(reads[i])
                if out_q is not None:
                    out_q.append(quals[i])
    return out_s, out_q, mappings


def polish_windows(
    center: np.ndarray,
    reads: Sequence[np.ndarray],
    mappings: Sequence,
) -> Optional[np.ndarray]:
    """Per-read center spans for anchor-bounded polishing, or None when no
    read benefits.  A read windows only when its padded span is narrower
    than the center; unmapped reads keep the full center."""
    L = center.size
    if L < AUTO_WINDOW_MIN_CENTER:
        return None
    win = np.zeros((len(reads), 2), dtype=np.int32)
    win[:, 1] = L
    narrowed = False
    for i, m in enumerate(mappings):
        if m is None:
            continue
        # strand-correct unaligned query flanks (PAF q coords are on the
        # original + strand); an 8%-indel inflation plus the fixed pad keeps
        # the true alignment inside while the window stays read-sized
        if m.strand == "+":
            head, tail = m.q_start, m.q_len - m.q_end
        else:
            head, tail = m.q_len - m.q_end, m.q_start
        lo = max(0, m.t_start - head - head // 8 - WINDOW_PAD)
        hi = min(L, m.t_end + tail + tail // 8 + WINDOW_PAD)
        if hi - lo < L:
            win[i, 0] = lo
            win[i, 1] = hi
            narrowed = True
    return win if narrowed else None


def polish_round(
    center: np.ndarray,
    reads: Sequence[np.ndarray],
    quals: Optional[Sequence[np.ndarray]] = None,
    windows: Optional[np.ndarray] = None,
    auto_window: bool = True,
) -> np.ndarray:
    """One round of pileup polishing: align reads to the fixed center, call a
    weighted plurality per column, with majority-supported insertions.

    Weights are ``1 - p_err`` per base when quality strings are given
    (medaka-class confidence weighting), else 1 (racon-class counting).
    Uncovered center positions keep the draft base.  Long centers
    (>= AUTO_WINDOW_MIN_CENTER) derive anchor-bounded per-read windows from
    the minimizer mapper unless explicit ``windows`` are given.
    """
    if not reads or center.size == 0:
        return center
    if windows is None and auto_window and center.size >= AUTO_WINDOW_MIN_CENTER:
        from .mapping import map_reads_to_center
        with span("poa.orient"):
            mappings = map_reads_to_center(center, reads)
        windows = polish_windows(center, reads, mappings)
    st = pileup_stats(center, reads, quals, windows)
    with span("poa.call"):
        return _call(center, st, quals is not None)


def _call(center: np.ndarray, st: PileupStats, weighted: bool) -> np.ndarray:
    """The polished sequence from the pileup: each column's call, then the
    insertion slots."""
    L = center.size
    votes = st.qvotes if weighted else st.votes
    coverage = st.coverage
    unit_votes = st.votes
    # Vectorized per-column call (VERDICT r3 item 5): identical decisions to
    # the per-position walk — argmax picks the first of tied bases, votes
    # accumulate unchanged, only the loop is gone.
    cov = votes.sum(axis=1)
    base_best = np.argmax(votes[:, :4], axis=1)
    best_v = votes[np.arange(L), base_best]
    uncovered = cov == 0.0
    deleted = (~uncovered & (votes[:, GAP_COL] > best_v)
               & (unit_votes[:, GAP_COL] >= MIN_STRUCT_EVIDENCE))
    call = np.where(uncovered, center,
                    _COL_TO_BASE[base_best]).astype(np.uint8)
    keep = ~deleted
    # insertion slots are sparse (indel-rate-sized): walk only slots with
    # at least one event (ins_open nonzero)
    inserts: List[Tuple[int, np.ndarray]] = []
    for p in np.flatnonzero(st.ins_open).tolist():
        d = st.ins_votes[p]
        total_ins = sum(d.values())
        best = sorted(d.items(), key=lambda kv: (-kv[1], kv[0]))[0]
        # Internal slots gate on the total insertion mass (error-driven
        # events whose keys mostly agree).  Terminal slots (p==0 / p==L)
        # collect overhangs from ANY read that runs past the center —
        # adapters, junk, wrong-orientation reads — so the winning key
        # itself must carry a majority, or a tiny-support plurality of
        # junk would extend the center.
        gate = best[1] if p == 0 or p == L else total_ins
        # structural edits need at least MIN_STRUCT_EVIDENCE reads: a
        # lone noisy read in a low-coverage pocket must not insert
        if gate > coverage[p] / 2.0 and st.ins_open[p] >= MIN_STRUCT_EVIDENCE:
            inserts.append((p, np.frombuffer(best[0], dtype=np.uint8)))
    if not inserts:
        return call[keep]
    parts: List[np.ndarray] = []
    prev = 0
    for p, payload in inserts:               # insert BEFORE center position p
        parts.append(call[prev:p][keep[prev:p]])
        parts.append(payload)
        prev = p
    parts.append(call[prev:][keep[prev:]])
    return np.concatenate(parts)
