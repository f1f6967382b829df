"""Whether what the timed path produced is right: the numbers compared.

Each number has its limit beside it (``PERF.md`` gives the readings each
limit was set from).  After the window closes, the references under
``reference/`` judge, for the libraries of the window:

``sorted_bad``     records of ``sorted.fastq`` that differ from the stage-1
                   reference's, over every library (limit 0);
``cluster_bad``    clustering passes that are not the ones the merge tree
                   implies, and read decisions that differ from the greedy
                   reference's, over the sampled libraries (the largest and
                   a seeded sample), every read; the alignment test reads
                   the reference DP's statistics, never the program's
                   (limit 0);
``tables_bad``     reads whose cluster in ``final_clusters.tsv`` is not the
                   one the passes' decisions give, over every library
                   (limit 0);
``stats_bad``      pairs of every stats call of the sampled libraries whose
                   results differ from the frozen plain DP's (limit 0);
``moves_bad``      the same for two moves calls of the sampled libraries,
                   the largest and a seeded one (limit 0);
``consensus_missing``  clusters at or above the abundance cutoff that are
                   not whole in exactly one consensus, and consensuses that
                   are not whole such clusters, over every library (limit 0);
``consensus_err``  the largest error of a polished consensus, over every
                   consensus of every library: against the core of the
                   species most of its reads come from, or, where another
                   species holds half as many or more, against the profile
                   of those species' cores (``CONSENSUS_LIMIT``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .reference import cluster as rc
from .reference import consensus as rcons
from .reference import dp as rdp
from .reference import stage1 as rs1

#: The worst polished consensus's edits per base that still passes.
#: Set between the readings of sound runs and of the control in PERF.md.
CONSENSUS_LIMIT = 0.045
#: Sampling: libraries whose DP calls and clustering are judged per run
#: (the largest and a seeded sample), read decisions per library judged at
#: most, moves calls judged per run.
CLUSTER_LIBRARIES = 3
CLUSTER_READS = 3000
DP_CALLS = 2


def upstream_config(argv: List[str]) -> dict:
    """The clustering's settings from a run's CLI flags, at upstream
    NGSpeciesID's defaults (its README's parameter list)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--ont", action="store_true")
    p.add_argument("--isoseq", action="store_true")
    p.add_argument("--k", type=int, default=13)
    p.add_argument("--w", type=int, default=20)
    p.add_argument("--q", dest="quality_threshold", type=float, default=7.0)
    p.add_argument("--t", dest="nr_cores", type=int, default=8)
    p.add_argument("--min_shared", type=int, default=5)
    p.add_argument("--mapped_threshold", type=float, default=0.7)
    p.add_argument("--aligned_threshold", type=float, default=0.4)
    p.add_argument("--symmetric_map_align_thresholds", dest="symmetric",
                   action="store_true")
    p.add_argument("--batch_type", default="total_nt")
    p.add_argument("--min_fraction", type=float, default=0.8)
    p.add_argument("--min_prob_no_hits", type=float, default=0.1)
    p.add_argument("--m", dest="target_length", type=int, default=0)
    p.add_argument("--s", dest="target_deviation", type=int, default=0)
    p.add_argument("--sample_size", type=int, default=0)
    p.add_argument("--top_reads", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--align_band", type=int, default=150)
    p.add_argument("--abundance_ratio", type=float, default=0.1)
    cfg = vars(p.parse_known_args(argv)[0])
    if cfg.pop("isoseq"):
        cfg["k"], cfg["w"] = 15, 50
    elif cfg.pop("ont"):
        cfg["k"], cfg["w"] = 13, 20
    return cfg


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def table_partition(path: str) -> Dict[str, frozenset]:
    groups: Dict[str, set] = {}
    with open(path) as f:
        for line in f:
            cl, acc = line.rstrip("\n").split("\t")
            groups.setdefault(cl, set()).add(acc)
    return {a: frozenset(g) for g in map(frozenset, groups.values()) for a in g}


def clustered_count(sorted_fastq: bytes, cfg: dict) -> int:
    """Reads the clustering sees (``reference/cluster.read_array``), from
    the reads' lengths alone."""
    lens = np.fromiter(map(len, sorted_fastq.split(b"\n")[1::4]), np.int64)
    if cfg["target_length"] > 0 and cfg["target_deviation"] > 0:
        lo = cfg["target_length"] - cfg["target_deviation"]
        hi = cfg["target_length"] + cfg["target_deviation"]
        lens = lens[(lens >= lo) & (lens <= hi)]
    n = int(lens.size)
    return min(n, cfg["sample_size"]) if cfg["sample_size"] > 0 else n


class Checker:
    """Runs the references over a run's kept libraries."""

    def __init__(self, argv: List[str], seed: int, device: str) -> None:
        self.cfg = upstream_config(argv)
        self.g = np.random.default_rng([int(seed) % (1 << 64), 77])
        self.device = device
        self.faults: Dict[str, List[str]] = {}
        self.values: Dict[str, Tuple[float, float]] = {}
        #: what each number was taken over: records, decisions, pairs, ...
        self.judged: Dict[str, int] = {}
        #: the reference DP's results of each kept stats call, by id
        self.ref_stats: Dict[int, list] = {}

    def note(self, name: str, why: str) -> None:
        self.faults.setdefault(name, []).append(why)

    # -- stage 1 -----------------------------------------------------------

    def sorted_reads(self, libs) -> None:
        bad = 0
        for lib in libs:
            got = _read(os.path.join(lib.out, "sorted.fastq"))
            want = rs1.sorted_fastq(_read(lib.fastq), self.cfg["k"],
                                    self.cfg["quality_threshold"])
            n = rs1.records_differing(got, want)
            if n:
                self.note("sorted_bad", f"library {lib.index}: {n} records")
            bad += n
            self.judged["sorted_records"] = self.judged.get(
                "sorted_records", 0) + len(rs1.parse_fastq(want))
        self.values["sorted_bad"] = (bad, 0)

    # -- stages 2-3 --------------------------------------------------------

    def clustering(self, libs, passes, calls, sampled) -> None:
        """Every library's tables; the sampled libraries' passes, each read
        decided again with the reference DP's statistics of the pairs the
        program aligned (``kernels`` computed them)."""
        cfg = self.cfg
        bad = tables = 0
        for lib in libs:
            mine = [p for p in passes if p.lib == lib.index]
            if not mine:
                continue
            reads = rc.read_sorted(_read(os.path.join(lib.out,
                                                      "sorted.fastq")))
            tables += self._tables(lib, mine, reads)
            if lib.index not in sampled:
                continue
            arr = rc.read_array(reads, cfg)
            judge = rc.Judge(arr, cfg)
            for why in self._orchestration(arr, mine, judge):
                self.note("cluster_bad", f"library {lib.index}: {why}")
                bad += 1
            stats = {}
            for c in calls:
                if c.kind == "stats" and c.lib == lib.index and c.ids is not None:
                    for a, b, go, mid, res in zip(c.rows1, c.rows2, c.gap_opens,
                                                  c.match_ids,
                                                  self.ref_stats[id(c)]):
                        stats[(int(c.ids[a]), int(c.ids[b]))] = (
                            (go, mid), (res[0], res[1]))
            total = sum(int((~p.skipped).sum()) for p in mine)
            sample = None
            if total > CLUSTER_READS:
                pool = [r for p in mine for r in p.ids[~p.skipped].tolist()]
                sample = set(self.g.choice(pool, CLUSTER_READS,
                                           replace=False).tolist())
            self.judged["cluster_libraries"] = self.judged.get(
                "cluster_libraries", 0) + 1
            self.judged["cluster_decisions"] = self.judged.get(
                "cluster_decisions", 0) + (total if sample is None else sum(
                    r in sample for p in mine
                    for r in p.ids[~p.skipped].tolist()))
            for p in mine:
                for why in rc.judge_pass(judge, p.ids.tolist(),
                                         p.skipped.tolist(), p.decisions,
                                         stats, sample):
                    self.note("cluster_bad", f"library {lib.index}: {why}")
                    bad += 1
        self.values["cluster_bad"] = (bad, 0)
        self.values["tables_bad"] = (tables, 0)

    def _orchestration(self, arr, passes, judge) -> List[str]:
        """The recorded passes against the ones the merge tree implies."""
        out = []
        expected = rc.first_shards(arr, self.cfg)
        if len(expected) == 1:
            expected_skip = [[False] * len(expected[0])]
        else:
            expected_skip = [[False] * len(s) for s in expected]
        at = 0
        while True:
            for j, (ids, skip) in enumerate(zip(expected, expected_skip)):
                if at + j >= len(passes):
                    return out + [f"pass {at + j} missing"]
                p = passes[at + j]
                if p.ids.tolist() != ids or p.skipped.tolist() != skip:
                    out.append(f"pass {at + j}: reads or skips differ from "
                               f"the merge tree's")
            results = [(ids, passes[at + j].alive.tolist())
                       for j, ids in enumerate(expected)]
            at += len(expected)
            if len(expected) == 1:
                if at != len(passes):
                    out.append(f"{len(passes) - at} passes after the last")
                return out
            batch_of = {r: j + 1 for j, ids in enumerate(expected) for r in ids}
            expected = rc.merge_round(results, batch_of, judge.by_id)
            expected_skip = []
            for ids in expected:
                low = max(1, min(batch_of[r] for r in ids))
                expected_skip.append([batch_of[r] == low for r in ids])

    def _tables(self, lib, passes, reads) -> int:
        """Reads whose cluster in final_clusters.tsv is not the one the
        passes' decisions give: each read with the representative it joined,
        and so on to a representative that never joined another."""
        acc = {r.rid: r.acc.rsplit("_", 1)[0] for r in reads}
        parent = {}
        for p in passes:
            for rid, rep in p.decisions.items():
                if rep != -1:
                    parent[rid] = rep
        groups: Dict[int, set] = {}
        root_of = {}
        for rid in {r for p in passes for r in p.ids.tolist()}:
            root, seen = rid, 0
            while root in parent and root >= 0 and seen <= len(parent):
                root, seen = parent[root], seen + 1
            root_of[rid] = root
            groups.setdefault(root, set()).add(acc[rid])
        table = table_partition(os.path.join(lib.out, "final_clusters.tsv"))
        bad = sum(root < 0 or table.get(acc[rid]) != groups[root]
                  for rid, root in root_of.items())
        if bad:
            self.note("tables_bad", f"library {lib.index}: {bad} reads")
        return bad

    # -- the DP kernels ----------------------------------------------------

    def kernels(self, calls) -> None:
        """Every kept stats call, in one reference DP batch, whose results
        the clustering's judge then reads; two kept moves calls."""
        stats = [c for c in calls if c.kind == "stats" and c.rows1]
        want = rdp.stats_calls(
            [(c.seqs, c.rows1, c.rows2, c.gap_opens, c.ks, c.match_ids,
              c.scoring, c.band) for c in stats], self.device)
        bad = 0
        self.ref_stats = {}
        for c, w in zip(stats, want):
            self.ref_stats[id(c)] = w
            n = sum(a != b for a, b in zip(c.out, w)) + abs(len(c.out) - len(w))
            if n:
                self.note("stats_bad", f"library {c.lib}, a call of "
                          f"{len(c.rows1)} pairs: {n} differ")
            bad += n
        self.judged["stats_pairs"] = sum(len(c.rows1) for c in stats)
        self.values["stats_bad"] = (bad, 0)

        mine = [c for c in calls if c.kind == "moves" and c.rows1]
        picked = []
        if mine:
            largest = max(range(len(mine)), key=lambda i: len(mine[i].rows1))
            picked.append(largest)
            rest = [i for i in range(len(mine)) if i != largest]
            k = min(DP_CALLS - 1, len(rest))
            if k:
                picked += self.g.choice(rest, k, replace=False).tolist()
        bad = 0
        for i in picked:
            c = mine[i]
            match, mismatch, gap_ext = c.scoring
            want = rdp.moves_call(c.seqs, c.rows1, c.rows2, c.gap_opens,
                                  match, mismatch, gap_ext, c.band,
                                  self.device)
            n = sum(not np.array_equal(a, b) for a, b in zip(c.out, want))
            n += abs(len(c.out) - len(want))
            self.judged["moves_pairs"] = self.judged.get(
                "moves_pairs", 0) + len(c.rows1)
            if n:
                self.note("moves_bad", f"library {c.lib}, a call of "
                          f"{len(c.rows1)} pairs: {n} differ")
            bad += n
        self.values["moves_bad"] = (bad, 0)

    # -- stage 4 -----------------------------------------------------------

    def consensus(self, libs) -> None:
        missing, errs, mixed = 0, [], 0
        for lib in libs:
            cutoff = int(self.cfg["abundance_ratio"] * clustered_count(
                _read(os.path.join(lib.out, "sorted.fastq")), self.cfg))
            for why in rcons.partition_faults(lib.out, cutoff):
                self.note("consensus_missing", f"library {lib.index}: {why}")
                missing += 1
            got, n_mixed = rcons.judge(lib.out, lib.library.pool.cores,
                                       lib.library.species, self.device)
            mixed += n_mixed
            if got and max(got) > CONSENSUS_LIMIT:
                self.note("consensus_err",
                          f"library {lib.index}: {max(got):.4f}")
            errs += got
        self.values["consensus_missing"] = (missing, 0)
        self.values["consensus_err"] = (max(errs, default=0.0),
                                        CONSENSUS_LIMIT)
        self.judged["consensuses"] = len(errs)
        self.judged["consensuses_mixed"] = mixed

    def correct(self) -> bool:
        return all(v <= limit for v, limit in self.values.values())
