"""Plain reference of stages 2-3: the greedy clustering, replayed read by read.

Upstream NGSpeciesID clusters reads greedily in score order (modules/
cluster.py as ``tests/oracle/cluster.py`` writes it down): a read joins the
first representative that passes the minimizer mapping test, or failing
that the alignment test, and otherwise becomes a representative whose
minimizers enter the database.  ``--t N`` runs that pass on N shards and
merges the shards' representatives pairwise (modules/parallelize.py), a
merge pass carrying the minimizer database of its lowest shard.

This module judges the program's clustering by following it pass by pass.
For each pass the harness records the reads it was given, in order, which
of them it skipped as already in the carried database, and the decision it
made for each read.  The reference then

* rebuilds the first round's shards from the sorted reads and each later
  round's passes from the round before it (``expected_passes``), and holds
  the recorded passes to them;
* decides each read again (``decide``) against the database that the
  program's own earlier decisions of that pass imply: the carried
  representatives and the new representatives before the read.  The first
  read the program decides wrongly is then decided against a database that
  is still right, so a wrong decision cannot hide behind an earlier one.

Minimizers, error rates and the mapping test are worked out here from the
reads; for the alignment test the reference takes the statistics that the
program's stats DP returned for the pair, and holds the DP's gap-open and
match-threshold inputs to its own.  The check of the DP itself is
``reference/dp.py``'s, on a sample of the window's launches.
"""

from __future__ import annotations

import math
import os
from collections import defaultdict, deque
from functools import reduce
from operator import mul
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .stage1 import P_CAPPED

_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "p_minimizers.csv")


def load_p_table(k: int, w: int, path: str = DATA) -> Dict[Tuple[float, float], float]:
    """{(e1, e2): p} for k and |w' - w| <= 2, both orders (NGSpeciesID:72-77)."""
    out = {}
    with open(path) as f:
        next(f)
        for line in f:
            kk, ww, e1, e2, p = line.split(",")
            if int(kk) == k and abs(int(ww) - w) <= 2:
                out[(float(e1), float(e2))] = float(p)
                out[(float(e2), float(e1))] = float(p)
    return out


def clamp(e: float) -> float:
    return min(max(round(e, 2), 0.01), 0.15)


class Read:
    """What the clustering needs of one sorted read."""

    __slots__ = ("rid", "acc", "score", "seq", "qual", "err", "full_err",
                 "hp_len", "minims", "_hp")

    def __init__(self, rid: int, acc: str, seq: bytes, qual: bytes) -> None:
        self.rid, self.acc, self.seq, self.qual = rid, acc, seq, qual
        self.score = float(acc.rsplit("_", 1)[1])
        s = np.frombuffer(seq, np.uint8)
        q = np.frombuffer(qual, np.uint8)
        starts = np.flatnonzero(np.concatenate([[True], s[1:] != s[:-1]]))
        self.hp_len = int(starts.size)
        # a run's quality is its best character (least capped p)
        run_q = np.maximum.reduceat(q, starts)
        self.err = _mean_p(run_q, len(run_q))
        self.full_err = _mean_p(q, len(seq))
        self.minims: Optional[List[Tuple[int, int]]] = None
        self._hp = _CODE[s[starts]]

    def minimizers(self, k: int, w: int) -> List[Tuple[int, int]]:
        """(k-mer, position) of the homopolymer-compressed read, emitted on
        change (cluster.py:16-39); k-mers as base-4 integers, whose order is
        the strings' order."""
        if self.minims is None:
            hp = self._hp.astype(np.int64)
            kms = np.lib.stride_tricks.sliding_window_view(hp, k) @ (
                4 ** np.arange(k - 1, -1, -1, dtype=np.int64))
            kms = kms.tolist()
            span = w - k
            window = deque(kms[: span + 1])
            cur = min(window)
            out = [(cur, list(window).index(cur))]
            for i in range(span + 1, len(kms)):
                new = kms[i]
                old = window.popleft()
                window.append(new)
                if cur == old:
                    cur = min(window)
                    out.append((cur, list(window).index(cur) + i - span))
                elif new < cur:
                    cur = new
                    out.append((new, i))
            self.minims = out
        return self.minims


def _mean_p(q: np.ndarray, n: int) -> float:
    counts = np.bincount(q, minlength=128)
    total = 0
    for c in np.flatnonzero(counts):
        total += int(counts[c]) * float(P_CAPPED[c])
    return total / n


def read_sorted(data: bytes) -> List[Read]:
    lines = data.split(b"\n")
    return [Read(i // 4, lines[i][1:].decode(), lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 3, 4)]


def read_array(reads: List[Read], cfg: dict) -> List[Read]:
    """The reads the clustering sees: the length window, then the top or a
    sample of ``sample_size`` (pipeline.load_read_array; the sample with
    Python's ``random.Random(seed)``, as the port seeds it)."""
    import random

    if cfg["target_length"] > 0 and cfg["target_deviation"] > 0:
        lo = cfg["target_length"] - cfg["target_deviation"]
        hi = cfg["target_length"] + cfg["target_deviation"]
        reads = [r for r in reads if lo <= len(r.seq) <= hi]
    if cfg["top_reads"]:
        return reads[: cfg["sample_size"]]
    if 0 < cfg["sample_size"] < len(reads):
        keep = sorted(random.Random(cfg["seed"]).sample(range(len(reads)),
                                                        cfg["sample_size"]))
        return [reads[i] for i in keep]
    return reads


def first_shards(reads: List[Read], cfg: dict) -> List[List[int]]:
    """The first round's shards (parallelize.py:33-81)."""
    n = cfg["nr_cores"]
    if n <= 1:
        return [[r.rid for r in reads]]
    kind = cfg["batch_type"]
    if kind == "nr_reads":
        chunk = len(reads) // n + 1
        return [[r.rid for r in reads[i: i + chunk]]
                for i in range(0, len(reads), chunk)]
    weight = ((lambda r: len(r.seq)) if kind == "total_nt" else
              (lambda r: math.pow(len(r.seq), 2)))
    tot = sum(weight(r) for r in reads)
    chunk = (tot // n + 1) if kind == "total_nt" else int(tot / n) + 1
    out, cur, acc = [], [], 0
    for r in reads:
        acc += weight(r)
        cur.append(r.rid)
        if acc >= chunk:
            out.append(cur)
            cur, acc = [], 0
    out.append(cur)
    return out


def merge_round(results: List[Tuple[List[int], List[int]]], batch_of: Dict[int, int],
                by_id: Dict[int, Read]) -> List[List[int]]:
    """The next round's passes from this round's (reads, survivors) per pass:
    survivors in pass order, re-sorted by score (stable), then split where a
    read's batch index passes 2, 4, ... (parallelize.py:150-217)."""
    surviving = []
    for ids, alive in results:
        alive = set(alive)
        surviving += [r for r in ids if r in alive]
    surviving.sort(key=lambda r: -by_id[r].score)
    out, cur, limit = [], [], 2
    for r in surviving:
        if batch_of[r] <= limit:
            cur.append(r)
        else:
            out.append(cur)
            limit += 2
            cur = [r]
    out.append(cur)
    return [b for b in out if b]


class Judge:
    """Decides reads again, as upstream's sequential loop would."""

    def __init__(self, reads: List[Read], cfg: dict) -> None:
        self.cfg = cfg
        self.by_id = {r.rid: r for r in reads}
        self.p_emp = load_p_table(cfg["k"], cfg["w"])

    def mapping_pass(self, read: Read, tops, hits_idx) -> int:
        cfg = self.cfg
        hp_len = read.hp_len
        n_min = len(read.minimizers(cfg["k"], cfg["w"]))
        top_hits = len(tops[0][1])
        for cl, positions in tops:
            nm = len(positions)
            if nm < cfg["min_fraction"] * top_hits or nm < cfg["min_shared"]:
                break
            idxs = hits_idx[cl]
            rep = self.by_id[cl]
            p_err = 1.0 - self.p_emp[(clamp(read.err), clamp(rep.err))]
            probs = ([reduce(mul, [p_err] * idxs[0], 1)]
                     + [reduce(mul, [p_err] * (i2 - i1 - 1), 1)
                        for i1, i2 in zip(idxs[:-1], idxs[1:])]
                     + [reduce(mul, [p_err] * (n_min - idxs[-1] - 1), 1)])
            total = 0
            for i in range(len(idxs)):
                if probs[i] >= cfg["min_prob_no_hits"]:
                    total += positions[i] if i == 0 else \
                        positions[i] - positions[i - 1]
            if probs[-1] >= cfg["min_prob_no_hits"]:
                total += hp_len - positions[-1]
            ratio = total / float(hp_len)
            rep_ratio = total / float(rep.hp_len)
            if cfg["symmetric"]:
                if min(ratio, rep_ratio) > cfg["mapped_threshold"]:
                    return cl
            elif ratio > cfg["mapped_threshold"]:
                return cl
        return -1

    def align_inputs(self, read: Read, rep: Read) -> Tuple[int, int]:
        """Gap-open penalty and match threshold of a pair (cluster.py:185-196)."""
        ers = read.full_err + rep.full_err
        go = 5 if ers <= 0.01 else 4 if ers <= 0.04 else 3 if ers <= 0.1 else 2
        return go, math.floor((1.0 - ers) * self.cfg["k"])

    def decide(self, read: Read, db: Dict[int, List[int]], stats) -> Tuple[int, str]:
        """(representative joined or -1, "" or why it could not be judged).
        ``db``: k-mer -> representatives before this read; ``stats``:
        (read id, rep id) -> (inputs, (ratio, rep ratio)) of the program."""
        cfg = self.cfg
        hits_idx = defaultdict(list)
        hits_pos = defaultdict(list)
        for i, (m, pos) in enumerate(read.minimizers(cfg["k"], cfg["w"])):
            for cl in db.get(m, ()):
                if cl != read.rid:
                    hits_idx[cl].append(i)
                    hits_pos[cl].append(pos)
        if not hits_pos:
            return -1, ""
        tops = sorted(hits_pos.items(),
                      key=lambda x: (len(x[1]), sum(x[1]), self.by_id[x[0]].acc),
                      reverse=True)
        top_hits = len(tops[0][1])
        if top_hits < cfg["min_shared"]:
            return -1, ""
        best = self.mapping_pass(read, tops, hits_idx)
        if best >= 0:
            return best, ""
        for cl, positions in tops:
            if len(positions) < top_hits:
                break
            got = stats.get((read.rid, cl))
            if got is None:
                return -1, f"read {read.rid}: no alignment with {cl} was made"
            inputs, (r1, r2) = got
            want = self.align_inputs(read, self.by_id[cl])
            if tuple(inputs) != want:
                return -1, (f"read {read.rid} vs {cl}: DP inputs {inputs}, "
                            f"expected {want}")
            if cfg["symmetric"]:
                if min(r1, r2) >= cfg["aligned_threshold"]:
                    return cl, ""
            elif r1 >= cfg["aligned_threshold"]:
                return cl, ""
        return -1, ""


def judge_pass(judge: Judge, ids: Sequence[int], skipped: Sequence[bool],
               decisions: Dict[int, int], stats, sample: Optional[set] = None
               ) -> List[str]:
    """Faults of one pass: reads in ``sample`` (all when None) decided
    otherwise than ``decisions`` (read id -> rep id, -1 for a new one)."""
    cfg = judge.cfg
    db: Dict[int, List[int]] = defaultdict(list)

    def insert(rid):
        # a set per k-mer: a representative counts once (cluster.py:329-334)
        for m in {m for m, _ in judge.by_id[rid].minimizers(cfg["k"],
                                                             cfg["w"])}:
            db[m].append(rid)

    for rid, skip in zip(ids, skipped):
        if skip:
            insert(rid)
    faults = []
    for rid, skip in zip(ids, skipped):
        if skip:
            continue
        got = decisions.get(rid)
        if sample is None or rid in sample:
            want, why = judge.decide(judge.by_id[rid], db, stats)
            if why:
                faults.append(why)
            elif got != want:
                faults.append(f"read {rid}: joined {got}, reference {want}")
        if got == -1:
            insert(rid)
    return faults
