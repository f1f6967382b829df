"""Stage 4 of the port at centres of 2 kb or more, against the JAX package.

At a centre of ``poa.AUTO_WINDOW_MIN_CENTER`` bases or more,
``poa.polish_round`` maps every polish read to the centre with the host
minimizer mapper and gives each read a window of the centre
(``polish_windows``); the pileup then aligns each read against its window
only.  A pool of ~2.2 kb amplicons, a fifth of whose reads cover only part
of the amplicon so that their windows narrow, goes through both packages'
``cli.main --consensus --medaka``: every output file must be byte-equal.
On one seeded centre of that length the ``torch`` backend's pileup (the
moves DP's and the pileup's plain versions, the path the card takes) must
equal the host walk ``poa._walk`` bit for bit under those windows, its
polish round the JAX package's, and the round's counters must count the
reads it mapped and the windows that narrowed.  At 4 kb a single repeated
minimizer in a centre sends every read's ~650 anchors to the mapper's chain
DP, whose chains must stay the JAX package's bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from ngspeciesid_tpu import cli as ref_cli
from ngspeciesid_tpu.ops import mapping as ref_mapping
from ngspeciesid_tpu.ops import poa as ref_poa
from ngspeciesid_tpu_torch import cli as port_cli
from ngspeciesid_tpu_torch import spans
from ngspeciesid_tpu_torch.consensus import stage as port_stage
from ngspeciesid_tpu_torch.ops import mapping, pileup, poa
from ngspeciesid_tpu_torch.ops.align import sg_align_batch
from ngspeciesid_tpu_torch.ops.mapping import map_reads_to_center
from ngspeciesid_tpu_torch.utils.seqs import reverse_complement_bytes

ACGT = np.frombuffer(b"ACGT", np.uint8)
#: the amplicon's length: above the windowed polish's gate
LENGTH = 2200


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain DPs run many small ops per diagonal, which extra intra-op
    threads only slow down (and the suite runs several workers at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def noisy(rng, template, rate=0.07):
    """ONT-like errors at ``rate``: deletions, substitutions and insertions
    alike."""
    third = rate / 3
    r = template[rng.random(template.size) >= third].copy()
    sub = rng.random(r.size) < third
    r[sub] = ACGT[rng.integers(0, 4, int(sub.sum()))]
    ins = np.flatnonzero(rng.random(r.size) < third)
    return np.insert(r, ins, ACGT[rng.integers(0, 4, ins.size)]).astype(
        np.uint8)


def part(rng, n):
    """A span of 50-80% of an amplicon of ``n`` bases, anywhere in it."""
    size = int(rng.integers(n // 2, 4 * n // 5))
    lo = int(rng.integers(0, n - size + 1))
    return lo, lo + size


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """240 reads of 2 unrelated species of ~2.2 kb, both strands: 96 whole
    amplicons and 24 reads of part of it a species."""
    rng = np.random.default_rng(2200)
    records = []
    for sp in range(2):
        template = ACGT[rng.integers(0, 4, LENGTH + 40 * sp)]
        for i in range(120):
            src = template if i % 5 else template[slice(*part(rng,
                                                             template.size))]
            seq = noisy(rng, src)
            if rng.random() < 0.5:
                seq = reverse_complement_bytes(seq)
            qual = (33 + rng.integers(8, 28, seq.size)).astype(np.uint8)
            records.append(b"@read_%d\n%s\n+\n%s\n" % (
                len(records), seq.tobytes(), qual.tobytes()))
    order = rng.permutation(len(records))
    path = tmp_path_factory.mktemp("long") / "pool.fastq"
    path.write_bytes(b"".join(records[i] for i in order))
    return str(path)


def _files(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


def test_cli_medaka_byte_equal_to_reference_at_long_centres(
        pool, tmp_path, monkeypatch):
    """Both packages on the C++ engine (the plain DPs at 2.2 kb would take
    minutes on the CPU; the next test holds the ``torch`` pileup to the
    same walk): every file equal, every centre polished through windows."""
    args = ["--ont", "--fastq", pool, "--t", "2", "--consensus", "--medaka",
            "--abundance_ratio", "0.1"]
    monkeypatch.setenv("NGSID_STATS_BACKEND", "native")
    assert ref_cli.main(args + ["--outfolder", str(tmp_path / "ref")]) == 0
    walls = {}
    assert port_cli.main(args + ["--outfolder", str(tmp_path / "port")],
                         stage_walls=walls) == 0
    want = _files(tmp_path / "ref")
    got = _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name

    polished = [n for n in got if n.endswith("consensus.fasta")]
    assert polished
    for name in polished:
        seq = got[name].split(b"\n")[1]
        assert len(seq) >= poa.AUTO_WINDOW_MIN_CENTER, name
    # two medaka rounds, each mapping every polish read of its centre
    reads = sum(min(got[n].count(b"\n") // 4, port_stage.POLISH_MAX_READS)
                for n in got if n.startswith("reads_to_consensus_"))
    assert walls["poa.window_reads"] == 2 * reads
    assert 0 < walls["poa.windowed"] < walls["poa.window_reads"]
    assert walls["poa.window"] > 0
    # the windows' mapping is not the orientation's
    assert walls["poa.orient"] > 0


def test_torch_pileup_under_long_windows_equals_the_walk(monkeypatch):
    """A 2,100-base centre, 8 whole reads and 4 of parts of it: the
    windows narrow for exactly the 4; the ``torch`` pileup under them
    equals ``_walk`` over the plain moves DP bit for bit; the polish round
    equals the JAX package's and counts 12 reads mapped, 4 windowed."""
    rng = np.random.default_rng(2100)
    center = ACGT[rng.integers(0, 4, 2100)]
    reads = [noisy(rng, center) for _ in range(8)]
    for lo, hi in ((0, 1200), (900, 2100), (500, 1700), (300, 1100)):
        reads.append(noisy(rng, center[lo:hi]))
    quals = [rng.integers(35, 75, size=r.size).astype(np.uint8)
             for r in reads]
    windows = poa.polish_windows(center, reads,
                                 map_reads_to_center(center, reads))
    assert windows is not None
    narrow = (windows[:, 1] - windows[:, 0]) < center.size
    assert narrow.tolist() == [False] * 8 + [True] * 4

    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    pileup.reset_counts()
    got = poa.pileup_stats(center, reads, quals, windows)
    assert pileup.PLAIN_READS == len(reads)
    want = poa.PileupStats(center.size)
    moves = sg_align_batch(
        [(center[lo:hi], r) for (lo, hi), r in zip(windows.tolist(), reads)],
        [poa.POA_OPEN] * len(reads), match=poa.POA_MATCH,
        mismatch=poa.POA_MISMATCH, gap_ext=poa.POA_EXT, backend="torch",
        band=poa.POA_BAND)
    poa._walk(want, center, reads, quals, windows, moves)
    for field in ("votes", "qvotes", "coverage", "ins_open"):
        a, b = getattr(got, field), getattr(want, field)
        assert np.array_equal(a.view(np.int64), b.view(np.int64)), field
    assert [list(d.items()) for d in got.ins_votes] == \
        [list(d.items()) for d in want.ins_votes]

    walls = {}
    with spans.sink(walls):
        mine = poa.polish_round(center, reads, quals)
    assert walls["poa.window_reads"] == len(reads)
    assert walls["poa.windowed"] == 4
    assert "poa.orient" not in walls
    monkeypatch.setenv("NGSID_STATS_BACKEND", "native")
    assert mine.tobytes() == ref_poa.polish_round(center, reads,
                                                  quals).tobytes()


def takes_the_dp(qa, ta):
    """Whether ``mapping._chain`` runs its DP on these anchors: they are
    not one clean colinear run, which it chains whole without one."""
    order = np.lexsort((qa, ta))
    dq, dt = np.diff(qa[order]), np.diff(ta[order])
    return not ((dq > 0).all() and (dt > 0).all()
                and (np.abs(dq - dt) <= mapping.MAX_GAP).all())


def test_chain_dp_equals_the_reference_on_4kb_reads_with_a_repeat(
        monkeypatch):
    """A 4 kb centre whose one 20-mer occurs twice, reads of it at 7%
    error on both strands, and anchor sets of small coordinates full of
    ties: the port's chains and mappings equal the JAX package's, and the
    repeat sends most reads through the DP."""
    rng = np.random.default_rng(4000)
    center = ACGT[rng.integers(0, 4, 4000)]
    center[3100:3120] = center[700:720]
    reads = [noisy(rng, center) for _ in range(12)]
    reads += [reverse_complement_bytes(noisy(rng, center)) for _ in range(4)]
    reads.append(noisy(rng, center[1500:3900]))
    calls = []
    real = mapping._chain

    def chain(qa, ta, k):
        calls.append(takes_the_dp(qa, ta))
        return real(qa, ta, k)

    monkeypatch.setattr(mapping, "_chain", chain)
    got = mapping.map_reads_to_center(center, reads)
    want = ref_mapping.map_reads_to_center(center, reads)
    assert [m.paf_fields("r", "c") for m in got] == \
        [m.paf_fields("r", "c") for m in want]
    assert sum(calls) >= len(reads) // 2
    for n, spread in ((60, 8), (300, 40), (900, 4000)):
        qa = rng.integers(0, spread, n)
        ta = qa + rng.integers(-3, 4, n) * rng.integers(0, 2, n) * 150
        for q, t in ((qa, ta), (qa, rng.integers(0, spread, n))):
            a = mapping._chain(q, t, 13)
            b = ref_mapping._chain(q, t, 13)
            assert (a is None) == (b is None)
            if a is not None:
                assert a[0].tolist() == b[0].tolist()
                assert a[1].tolist() == b[1].tolist()
