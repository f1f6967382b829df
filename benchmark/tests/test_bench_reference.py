"""The plain references the check runs: the batched stats DP, the
consensus's truth, the consensus partition, and which libraries' calls are
kept."""

import os

import numpy as np
import pytest

from benchmark import hooks, traffic
from benchmark.reference import consensus as rcons
from benchmark.reference import dp


def _calls(g, n_calls, lengths, bands):
    out = []
    for ci in range(n_calls):
        core = traffic.ACGT[g.integers(0, 4, int(g.integers(*lengths)))]
        seqs = [traffic.mutate(g, core, float(g.uniform(0.02, 0.3)), 0.05)
                for _ in range(6)]
        seqs += [traffic.ACGT[g.integers(0, 4, int(g.integers(*lengths)))]
                 for _ in range(2)]
        n = int(g.integers(1, 9))
        r1 = g.integers(0, len(seqs), n).tolist()
        r2 = g.integers(0, len(seqs), n).tolist()
        out.append((seqs, r1, r2, g.integers(2, 6, n).tolist(), [13] * n,
                    g.integers(-1, 13, n).tolist(), (2, -2, 1),
                    bands[ci % len(bands)]))
    return out


@pytest.mark.parametrize("lengths,bands,max_pairs", [
    ((40, 200), (0, 150, 20), 4096),
    ((40, 200), (0, 150, 20), 5),
    ((560, 700), (150,), 4096)])
def test_many_calls_at_once_equal_each_call_alone(lengths, bands, max_pairs):
    """Chunks of several calls in one wavefront, each pair in its own
    chunk's window, give every pair the row its call gives it alone (the
    long pairs run in a window narrower than their matrix)."""
    g = np.random.default_rng(lengths[0] + max_pairs)
    calls = _calls(g, 3, lengths, bands)
    want = [dp.stats_call(*c[:6], *c[6], band=c[7]) for c in calls]
    got = dp.stats_calls(calls, max_pairs=max_pairs)
    assert got == want


def _levenshtein_into(core: bytes, cons: bytes) -> int:
    """Edits turning ``core`` into a substring of ``cons``, by the book."""
    prev = [0] * (len(cons) + 1)
    for i, c in enumerate(core, 1):
        cur = [i] + [0] * len(cons)
        for j, x in enumerate(cons, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (c != x))
        prev = cur
    return min(prev)


def test_one_core_is_plain_edit_distance_into_the_consensus():
    g = np.random.default_rng(12)
    for _ in range(20):
        core = traffic.ACGT[g.integers(0, 4, int(g.integers(5, 40)))]
        cons = np.concatenate([traffic.ACGT[g.integers(0, 4, 3)],
                               traffic.mutate(g, core, 0.2, 0.3),
                               traffic.ACGT[g.integers(0, 4, 2)]])
        allowed, optional = rcons.profile([core])
        assert rcons.edits_into(allowed, optional, cons) == \
            _levenshtein_into(core.tobytes(), cons.tobytes())


def test_a_mosaic_of_the_contenders_reads_right():
    """Where two congeners share a cluster evenly, a consensus that takes
    each column from either core (a codon indel of the second included)
    reads no error; a base of neither, or another species, reads one."""
    g = np.random.default_rng(13)
    core = traffic.ACGT[g.integers(0, 4, 300)]
    mate = traffic.mutate(g, core, 0.08, 0.0)
    mate = np.delete(np.insert(mate, 200, traffic.ACGT[[0, 1, 2]]),
                     np.s_[60:63])
    # mate's base 147 is core's 150: three bases of it went at 60
    mosaic = np.concatenate([core[:150], mate[147:]])
    assert rcons.error([core, mate], mosaic) == 0
    assert rcons.error([core, mate], traffic.revcomp(mosaic)) == 0
    assert rcons.error([core], mosaic) > 0.02
    wrong = mosaic.copy()
    wrong[100] = [x for x in traffic.ACGT if x not in (core[100], mate[100])][0]
    assert rcons.error([core, mate], wrong) == pytest.approx(1 / 300)
    other = traffic.mutate(g, core, 0.15, 0.0)
    assert rcons.error([core, mate], other) > 0.05


def _folder(tmp, clusters, consensus_reads):
    with open(os.path.join(tmp, "final_clusters.tsv"), "w") as f:
        for cl, reads in clusters.items():
            for r in reads:
                f.write(f"{cl}\tlib0_{r}\n")
    for c_id, reads in consensus_reads.items():
        os.makedirs(os.path.join(tmp, f"medaka_cl_id_{c_id}"))
        with open(os.path.join(tmp, f"medaka_cl_id_{c_id}",
                               "consensus.fasta"), "w") as f:
            f.write(f">c{c_id}\nACGT\n")
        with open(os.path.join(tmp, f"reads_to_consensus_{c_id}.fastq"),
                  "w") as f:
            for r in reads:
                f.write(f"@lib0_{r}_0.9\nACGT\n+\nIIII\n")
    return str(tmp)


@pytest.mark.parametrize("case,faults", [
    ("whole", 0), ("merged", 0), ("dropped", 1), ("split", 3),
    ("stray", 1)])
def test_consensus_partition(tmp_path, case, faults):
    """Clusters at the cutoff (3 reads here) lie whole in one consensus
    each; a merge of two is fine; a dropped, split or padded one is not."""
    clusters = {"0": [0, 1, 2, 3], "4": [4, 5, 6], "7": [7, 8]}
    cons = {"whole": {"0": [0, 1, 2, 3], "4": [4, 5, 6]},
            "merged": {"0": [0, 1, 2, 3, 4, 5, 6]},
            "dropped": {"0": [0, 1, 2, 3]},
            "split": {"0": [0, 1], "9": [2, 3], "4": [4, 5, 6]},
            "stray": {"0": [0, 1, 2, 3, 7], "4": [4, 5, 6]}}[case]
    got = rcons.partition_faults(_folder(tmp_path, clusters, cons), 3)
    assert len(got) == faults, got


def test_recorder_keeps_the_largest_and_a_seeded_sample():
    """Calls are kept for the largest library and ``keep - 1`` others of
    lowest seeded priority; every call's lengths are kept."""
    rec = hooks.Recorder(keep=3, seed=2**31 + 9)
    sizes = [300, 2000, 150, 800, 2500, 90, 1200]
    seqs = [np.zeros(10, np.uint8), np.zeros(20, np.uint8)]
    for i, n in enumerate(sizes):
        rec.new_library(i)
        rec.calls.append(hooks.Call("stats", i, seqs, [0], [1], [3], [13],
                                    [9], (2, -2, 1), 150, [(0.5, 0.5, 0.9)]))
        rec.end_library(n)
    assert len(rec.launches) == len(sizes)
    assert rec.launches[0].len1.tolist() == [10]
    assert len(rec.sampled) == 3 and 4 in rec.sampled
    others = sorted((i for i in range(len(sizes)) if i != 4),
                    key=rec._priority)[:2]
    assert rec.sampled == sorted([4] + others)
    assert sorted({c.lib for c in rec.calls}) == rec.sampled
