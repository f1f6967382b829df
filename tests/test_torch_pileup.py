"""The polish pileup on the moves DP's traced paths (``ops/pileup.py``).

Under the ``torch`` backend ``poa.pileup_stats`` runs the moves DP's plain
version and then the pileup's (``walk_rows_plain``, ``reduce_rows_plain``)
on the paths where the DP left them.  Every output must equal the host
walk's (``poa._walk`` over the full-span moves of the same DP) bit for bit:
votes, qvotes, coverage, ins_open, and every dict of ins_votes with its
keys in the same order.  One case holds the JAX package's ``pileup_stats``
as the oracle instead; a test marked ``cuda`` holds the kernel
(``csrc/pileup_kernel.cu``) to the plain version on the card.
"""

import numpy as np
import pytest
import torch

from ngspeciesid_tpu_torch import spans
from ngspeciesid_tpu_torch.ops import align_moves, pileup, poa
from ngspeciesid_tpu_torch.ops.align import NEG_INF, sg_align_batch
from ngspeciesid_tpu_torch.ops.align_stats import pair_rows
from ngspeciesid_tpu_torch.utils.seqs import reverse_complement_bytes

ACGT = np.frombuffer(b"ACGT", np.uint8)
#: the read length the "empty_band" case marks as having no reachable
#: endpoint
UNREACHABLE_LEN = 97


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def noisy(rng, template, rate=0.06):
    """A copy of ``template`` with substitutions, deletions and insertions
    at ``rate`` each."""
    r = template[rng.random(template.size) >= rate].copy()
    sub = rng.random(r.size) < rate
    r[sub] = ACGT[rng.integers(0, 4, int(sub.sum()))]
    ins = np.flatnonzero(rng.random(r.size) < rate)
    return np.insert(r, ins, ACGT[rng.integers(0, 4, ins.size)]).astype(
        np.uint8)


def case(rng, L, n, windowed, features=()):
    """A center of L bases, n noisy reads of it and each feature's reads,
    seeded qualities, and per-read windows when ``windowed``."""
    center = ACGT[rng.integers(0, 4, L)]
    reads = [noisy(rng, center) for _ in range(n)]
    spans_ = [(0, L)] * n
    if windowed:
        # reads of parts of the center, windows padded around them; the
        # first two touch the center's head and tail
        for lo, hi in ((0, L // 2), (L // 2, L), (L // 4, 3 * L // 4)):
            reads.append(noisy(rng, center[lo:hi]))
            spans_.append((max(0, lo - 15), min(L, hi + 15)))
    if "rc_junk" in features:          # the wrong strand; an all-N read,
        reads.append(reverse_complement_bytes(reads[0]))   # no diagonal
        reads.append(np.full(40, ord("N"), np.uint8))
        spans_ += [(0, L)] * 2
    if "n_bases" in features:
        r = reads[1].copy()
        r[rng.integers(0, r.size, 6)] = ord("N")
        reads.append(r)
        spans_.append((0, L))
    if "long_runs" in features:        # overhangs and an insertion of >= 8
        mid = L // 2
        reads.append(np.concatenate([
            ACGT[rng.integers(0, 4, 12)], center[:mid],
            ACGT[rng.integers(0, 4, 17)], center[mid:],
            ACGT[rng.integers(0, 4, 9)]]).astype(np.uint8))
        reads.append(np.concatenate([
            ACGT[rng.integers(0, 4, 30)], noisy(rng, center)]).astype(
                np.uint8))
        spans_ += [(0, L)] * 2
    if "chunks" in features:           # other length buckets: other chunks
        reads += [noisy(rng, center[: L // 3]) for _ in range(3)]
        spans_ += [(0, L)] * 3
    if "empty_band" in features:
        reads.append(noisy(rng, center)[:UNREACHABLE_LEN])
        spans_.append((0, L))
    quals = [rng.integers(35, 75, size=r.size).astype(np.uint8)
             for r in reads]
    windows = np.array(spans_, np.int32) if windowed else None
    return center, reads, quals, windows


def pairs_of(center, reads, windows):
    return [(center if windows is None else
             center[windows[i, 0]:windows[i, 1]], r)
            for i, r in enumerate(reads)]


def walk(center, reads, quals, windows, backend="torch"):
    """The oracle: the host walk over the full-span moves of the backend's
    DP (the plain moves DP by default)."""
    st = poa.PileupStats(center.size)
    moves = sg_align_batch(pairs_of(center, reads, windows),
                           [poa.POA_OPEN] * len(reads), match=poa.POA_MATCH,
                           mismatch=poa.POA_MISMATCH, gap_ext=poa.POA_EXT,
                           backend=backend, band=poa.POA_BAND)
    poa._walk(st, center, reads, quals, windows, moves)
    return st


def assert_same(got, want):
    for field in ("votes", "qvotes", "coverage", "ins_open"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape, field
        assert np.array_equal(a.view(np.int64), b.view(np.int64)), field
    assert [list(d.items()) for d in got.ins_votes] == \
        [list(d.items()) for d in want.ins_votes]


def unreachable(real, hits):
    """moves_rows with the endpoint rows of reads of UNREACHABLE_LEN bases
    set to no reachable endpoint, as an empty band leaves them; ``hits``
    gets the number of such pairs a launch."""
    def call(pool, pm, base, *args, **kwargs):
        best, ops = real(pool, pm, base, *args, **kwargs)
        hit = pm[:, 1] == UNREACHABLE_LEN
        best[hit, 0] = int(NEG_INF)
        best[hit, 8] = int(NEG_INF)
        ops[hit] = 0
        hits.append(int(hit.sum()))
        return best, ops
    return call


CASES = {
    "quals": dict(quals=True),
    "no_quals": dict(quals=False),
    "windows": dict(quals=True, windowed=True),
    "windows_no_quals": dict(quals=False, windowed=True),
    "rc_junk": dict(quals=True, features=("rc_junk",)),
    "empty_band": dict(quals=True, features=("empty_band",)),
    "long_runs": dict(quals=True, features=("long_runs",)),
    "n_bases": dict(quals=True, features=("n_bases",)),
    "chunks": dict(quals=True, windowed=True, features=("chunks",)),
    "jax_reference": dict(quals=True, features=("rc_junk", "long_runs")),
    # the C++ engine's fused pileup through the same event fold (its
    # weights of runs of 8 or more are summed in another order than
    # numpy's, so none here)
    "native_fold": dict(quals=True, windowed=True, backend="native",
                        features=("rc_junk", "n_bases")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pileup_equals_the_walk(name, monkeypatch):
    spec = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 101)
    features = spec.get("features", ())
    center, reads, quals, windows = case(rng, 150, 10,
                                         spec.get("windowed", False),
                                         features)
    if not spec["quals"]:
        quals = None
    hits = []
    if "empty_band" in features:
        monkeypatch.setattr(align_moves, "moves_rows",
                            unreachable(align_moves.moves_rows, hits))
    backend = spec.get("backend", "torch")
    monkeypatch.setenv("NGSID_STATS_BACKEND", backend)
    pileup.reset_counts()
    got = poa.pileup_stats(center, reads, quals, windows)
    assert pileup.PLAIN_READS == (len(reads) if backend == "torch" else 0)
    if name == "jax_reference":
        # the JAX package's Python walk over its C++ engine's banded moves
        # (its fused C++ pileup sums a run's weights in another order)
        ref_poa = pytest.importorskip("ngspeciesid_tpu.ops.poa")
        monkeypatch.setenv("NGSID_PILEUP", "python")
        monkeypatch.setenv("NGSID_STATS_BACKEND", "native")
        want = ref_poa.pileup_stats(center, reads, quals, windows)
    else:
        want = walk(center, reads, quals, windows, backend)
    assert_same(got, want)
    # what each case is there for is in it
    seqs, r1, r2 = pair_rows(pairs_of(center, reads, windows))
    if "chunks" in features:
        assert len(align_moves._plan(seqs, r1, r2)) > 1
    if "empty_band" in features:
        assert sum(hits) == 2          # once in each path
    if "long_runs" in features:
        assert any(len(k) >= 8 for d in want.ins_votes for k in d)
        assert want.ins_votes[0] and want.ins_votes[-1]
    if windows is not None:
        assert (windows[:, 0] == 0).any() and (windows[:, 1] == 150).any()
        assert ((windows[:, 0] > 0) & (windows[:, 1] < 150)).any()


def test_event_weights_are_numpys_slice_sums():
    """event_arrays sums runs of one length as rows; numpy adds a row as it
    adds the walk's slice, short or long (pairwise from 8 on)."""
    rng = np.random.default_rng(5)
    reads = [ACGT[rng.integers(0, 4, n)] for n in (300, 40, 700)]
    quals = [rng.integers(33, 127, size=r.size).astype(np.uint8)
             for r in reads]
    ev = [(0, rd, lo, lo + ln) for rd, r in enumerate(reads)
          for ln in (1, 2, 3, 7, 8, 9, 16, 17, 33, 129, 257)
          for lo in rng.integers(0, max(1, r.size - ln), 3).tolist()
          if lo + ln <= r.size]
    events = np.array(ev, np.int32)
    pos, w, ln, ev_bytes = pileup.event_arrays(reads, quals, events)
    at = 0
    for (_, rd, lo, hi), wi, n in zip(ev, w.tolist(), ln.tolist()):
        ww = 1.0 - poa.PHRED_TO_P_CAPPED[quals[rd]]
        assert wi == float(ww[lo:hi].sum()) / (hi - lo)
        assert ev_bytes[at: at + n].tobytes() == reads[rd][lo:hi].tobytes()
        at += n


def test_walk_card_counts_every_polished_read(monkeypatch):
    """Every polished read takes the device path, its pairs through
    align_moves.sg_moves_pool_torch, where a wrapper (the benchmark's
    recorder, chip_smoke.py's pair count) sees them; the result the
    wrapper keeps, read after the pileup, is the pairs' moves."""
    rng = np.random.default_rng(9)
    center, reads, quals, _ = case(rng, 120, 8, False, ("rc_junk",))
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    kept = []
    real = align_moves.sg_moves_pool_torch

    def recorded(seqs, rows1, rows2, gap_opens, **kwargs):
        out = real(seqs, rows1, rows2, gap_opens, **kwargs)
        kept.append((seqs, rows1, rows2, gap_opens, kwargs, out))
        return out

    monkeypatch.setattr(align_moves, "sg_moves_pool_torch", recorded)
    walls = {}
    with spans.sink(walls):
        poa.polish_round(center, reads, quals)
        poa.polish_round(center, reads, None)
    assert walls["poa.reads"] == 2 * len(reads) == sum(
        len(k[1]) for k in kept)
    assert walls["poa.walk_card"] == walls["poa.reads"]
    assert walls["poa.walk"] > 0
    for seqs, rows1, rows2, gap_opens, kwargs, out in kept:
        want = list(real(seqs, rows1, rows2, gap_opens, **kwargs))
        assert len(out) == len(want)
        assert all(np.array_equal(g, w) for g, w in zip(out, want))
        assert out.chunks is None      # read: the device tensors let go


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the pileup kernel runs only on the card")
    rng = np.random.default_rng(17)
    center, reads, quals, windows = case(
        rng, 400, 60, True, ("rc_junk", "long_runs", "n_bases", "chunks"))
    for q in (quals, None):
        monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
        want = poa.pileup_stats(center, reads, q, windows)
        monkeypatch.setenv("NGSID_STATS_BACKEND", "cuda")
        pileup.reset_counts()
        got = poa.pileup_stats(center, reads, q, windows)
        assert pileup.READS == len(reads) and pileup.PLAIN_LAUNCHES == 0
        assert_same(got, want)
