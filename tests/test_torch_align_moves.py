"""The port's moves DP (ngspeciesid_tpu_torch.ops.align_moves) against the
JAX package.

On the CPU the port runs the moves kernel's plain PyTorch version.  Its raw
endpoint rows and op streams must equal, bit for bit, those of the Pallas
``_moves_kernel`` in interpret mode on the same chunk, and the full-span
move arrays its public entry point returns must equal the Pallas path's
(and, at band 0, the numpy oracle's).  The CUDA kernel is held against the
same plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ngspeciesid_tpu.ops import align_moves_pallas as ref
from ngspeciesid_tpu.ops.align import sg_align_batch as ref_sg_align_batch
from ngspeciesid_tpu_torch.ops import align as port_align
from ngspeciesid_tpu_torch.ops import align_moves as port
from ngspeciesid_tpu_torch.ops import align_stats

CPU = torch.device("cpu")
POA = dict(match=2, mismatch=-2, gap_ext=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain DP runs many small ops per diagonal, which extra intra-op
    threads only slow down (and the suite runs several workers at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand_seq(rng, n):
    return rng.integers(65, 69, size=n).astype(np.uint8)


def mutate(rng, s, rate):
    out = []
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(int(c))
        if r < 2 * rate / 3:
            out.append(int(rng.integers(65, 69)))
    return np.array(out, dtype=np.uint8)


def check_chunk(seqs, rows1, rows2, opens, band, match=2, mismatch=-2,
                gap_ext=1):
    """One chunk through the plain version and the interpreted Pallas
    kernel: raw rows and op streams bit-equal, and the public entry point's
    move arrays equal to the Pallas reconstruction.  Returns the moves."""
    B = len(rows1)
    assert len(port._plan(seqs, rows1, rows2)) == 1
    pool = align_stats.SeqPool(CPU)
    pool.ensure(seqs)
    pm, base, W, d_max, len1, len2 = align_stats.stage_chunk(
        pool, seqs, rows1, rows2, opens, [0] * B, [0] * B, band)
    best, ops = port.moves_rows(pool.buf, pm, base, W, d_max, band, match,
                                mismatch, gap_ext)
    r_best, r_ops, _, _ = ref._launch(seqs, rows1, rows2, opens, match,
                                      mismatch, gap_ext, band, True)
    r_best = np.asarray(r_best)[:B]
    r_ops = np.asarray(r_ops)[:B]
    assert np.array_equal(best.numpy(), r_best[:, :16])
    assert not r_best[:, 16:].any()
    assert np.array_equal(ops.numpy(), r_ops)
    want = ref._reconstruct(r_best, r_ops, len1, len2)
    got = port.sg_moves_pool_torch(seqs, rows1, rows2, opens, match=match,
                                   mismatch=mismatch, gap_ext=gap_ext,
                                   band=band, device=CPU)
    for g, w in zip(got, want):
        assert g.tolist() == w.tolist()
    return got


def pair_chunk(pairs):
    seqs = [s for p in pairs for s in p]
    return seqs, list(range(0, len(seqs), 2)), list(range(1, len(seqs), 2))


def test_band0_mutated_and_unrelated_match_pallas_and_oracle(rng):
    pairs, opens = [], []
    for t in range(12):
        a = rand_seq(rng, int(rng.integers(140, 240)))
        b = mutate(rng, a, 0.15) if t % 3 else \
            rand_seq(rng, int(rng.integers(140, 240)))
        pairs.append((a, b))
        opens.append(int(rng.choice([2, 3, 4, 5])))
    got = check_chunk(*pair_chunk(pairs), opens, band=0)
    want = ref_sg_align_batch(pairs, opens, backend="numpy")
    mine = port_align.sg_align_batch(pairs, opens, backend="numpy")
    for g, w, m in zip(got, want, mine):
        assert g.tolist() == w.tolist() == m.tolist()


def test_poa_scoring_matches_pallas(rng):
    pairs = []
    for _ in range(10):
        a = rand_seq(rng, int(rng.integers(150, 240)))
        pairs.append((a, mutate(rng, a, 0.1)))
    check_chunk(*pair_chunk(pairs), [2] * len(pairs), band=150, **POA)


def test_band150_mutated_pairs_match_pallas(rng):
    pairs, opens = [], []
    for _ in range(12):
        a = rand_seq(rng, int(rng.integers(280, 300)))
        b = mutate(rng, a, 0.12)
        pairs.append((a, b[:300] if b.size > 300 else b))
        opens.append(int(rng.choice([2, 3, 4, 5])))
    check_chunk(*pair_chunk(pairs), opens, band=150)


def test_band8_unrelated_pairs_leave_the_band_and_the_window(rng):
    # optimal paths leave a narrow band, so the semantics of out-of-band
    # cells (unreachable H, free-running E/F inside the window) and of
    # lanes that leave the window decide both the endpoint and the stream
    pairs, opens = [], []
    for t in range(16):
        a = rand_seq(rng, int(rng.integers(70, 128)))
        b = rand_seq(rng, int(rng.integers(70, 128)))
        if t % 4 == 0:
            b = np.concatenate([rand_seq(rng, 20), a[: 100 - 20]])
        pairs.append((a, b))
        opens.append(int(rng.choice([2, 3, 5])))
    seqs, r1, r2 = pair_chunk(pairs)
    moves = check_chunk(seqs, r1, r2, opens, band=8, **POA)
    full = port_align.sg_align_batch(pairs, opens, backend="numpy", **POA)
    # the narrow band changes some alignments: the case is not vacuous
    assert any(m.tolist() != f.tolist() for m, f in zip(moves, full))


def test_one_center_many_reads_through_shared_rows(rng):
    center = rand_seq(rng, 280)
    reads = [mutate(rng, center, 0.1)[:300] for _ in range(10)]
    seqs = [center] + reads
    check_chunk(seqs, [0] * len(reads), list(range(1, len(seqs))),
                [2] * len(reads), band=150, **POA)


class TestWrapper:
    def test_plain_counts_launches_and_pairs(self, rng):
        port.reset_counts()
        pairs = [(rand_seq(rng, 50), rand_seq(rng, 60)) for _ in range(3)]
        port.sg_moves_batch_torch(pairs, [3] * 3, device=CPU)
        assert (port.PLAIN_LAUNCHES, port.PLAIN_PAIRS) == (1, 3)
        assert (port.LAUNCHES, port.PAIRS) == (0, 0)

    @pytest.mark.parametrize("fn", ["pool", "batch"])
    def test_entry_points_default_to_the_backends_device(self, rng,
                                                         monkeypatch, fn):
        # device=None: cuda:0 under the default backend, which raises with
        # no GPU; the CPU only when the backend asks for it
        pairs = [(rand_seq(rng, 40), rand_seq(rng, 50)) for _ in range(2)]
        calls = {
            "pool": lambda: port.sg_moves_pool_torch(
                [a for p in pairs for a in p], [0, 2], [1, 3], [3, 3]),
            "batch": lambda: port.sg_moves_batch_torch(pairs, [3, 3]),
        }
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
        port.reset_counts()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[fn]()
        monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
        out = calls[fn]()
        assert len(out) == 2
        assert (port.PLAIN_LAUNCHES, port.PLAIN_PAIRS) == (1, 2)
        assert (port.LAUNCHES, port.PAIRS) == (0, 0)

    def test_chunk_plan_equals_reference(self, rng):
        seqs = [rand_seq(rng, int(n)) for n in rng.integers(30, 1700, 90)]
        rows1 = rng.integers(0, 90, 1400).tolist()
        rows2 = rng.integers(0, 90, 1400).tolist()
        assert port._plan(seqs, rows1, rows2) == \
            ref._plan(seqs, rows1, rows2)

    def test_rejects_malformed_inputs(self):
        pool = torch.zeros(64, dtype=torch.uint8)
        pm = torch.ones((2, 8), dtype=torch.int64)
        base = torch.zeros(16, dtype=torch.int32)
        best, ops = port.moves_rows(pool, pm, base, 128, 15, 0)
        assert best.shape == (2, 16) and ops.shape == (2, 16)
        with pytest.raises(ValueError):
            port.moves_rows(pool.to(torch.int32), pm, base, 128, 15, 0)
        with pytest.raises(ValueError):
            port.moves_rows(pool, pm.to(torch.int32), base, 128, 15, 0)
        with pytest.raises(ValueError):
            port.moves_rows(pool, pm, base, 128, 16, 0)   # base too short
        with pytest.raises(ValueError):
            port.moves_rows(pool, pm, base[::2], 128, 7, 0)

    @pytest.mark.parametrize("backend", ["torch", "host", "numpy"])
    def test_sg_align_batch_backends_agree_at_band0(self, rng, backend):
        pairs = [(rand_seq(rng, int(rng.integers(20, 90))),) for _ in range(4)]
        pairs = [(a, mutate(rng, a, 0.1)) for (a,) in pairs]
        want = ref_sg_align_batch(pairs, [3] * 4, backend="numpy")
        got = port_align.sg_align_batch(pairs, [3] * 4, backend=backend)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
