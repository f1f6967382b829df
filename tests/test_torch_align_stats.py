"""The port's stats DP (ngspeciesid_tpu_torch.ops.align_stats) against the
JAX package.

On the CPU the port runs the kernel's plain PyTorch version.  Its per-pair
(aligned_ratio_s1, aligned_ratio_s2, identity) must equal, with abs=0, the
JAX package's numpy oracle (full traceback + match_vector +
block_aligned_stats + identity_from_moves) and, where paths leave a narrow
band, the Pallas kernel in interpret mode.  The CUDA kernel is held against
the same plain version on the card by chip_smoke.py.
"""

import math
import sys
import threading

import numpy as np
import pytest
import torch

from ngspeciesid_tpu.ops import align_stats_pallas as ref
from ngspeciesid_tpu.ops.align import (
    block_aligned_stats,
    identity_from_moves,
    match_vector,
    sg_align_numpy,
)
from ngspeciesid_tpu_torch import device as port_device
from ngspeciesid_tpu_torch.ops import align as port_align
from ngspeciesid_tpu_torch.ops import align_stats as port

CPU = torch.device("cpu")


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


def oracle(a, b, gap_open, k, match_id):
    moves = sg_align_numpy(a, b, gap_open)
    mv = match_vector(moves, a, b)
    r1, r2 = block_aligned_stats(mv, k, match_id, a.size, b.size)
    return r1, r2, identity_from_moves(moves, a, b)


def assert_oracle(pairs, opens, ks, mids, band=0):
    got = port.sg_stats_batch_torch(pairs, opens, ks, mids, band=band,
                                    device=CPU)
    for i, (a, b) in enumerate(pairs):
        want = oracle(a, b, opens[i], ks[i], mids[i])
        assert got[i] == pytest.approx(want, abs=0.0), (i, got[i], want)


class TestPlainAgainstOracle:
    def test_random_pairs(self, rng):
        pairs, opens, ks, mids = [], [], [], []
        for _ in range(16):
            pairs.append((rand_seq(rng, int(rng.integers(8, 90))),
                          rand_seq(rng, int(rng.integers(8, 90)))))
            opens.append(int(rng.choice([2, 3, 5])))
            ks.append(int(rng.integers(5, 22)))
            mids.append(int(rng.integers(-2, ks[-1] + 1)))
        assert_oracle(pairs, opens, ks, mids)

    @pytest.mark.parametrize("kset", [(5, 9, 13), (15, 17, 21), (26, 28, 30)])
    def test_mutated_copies(self, rng, kset):
        pairs, opens, ks, mids = [], [], [], []
        for t in range(9):
            a = rand_seq(rng, int(rng.integers(60, 200)))
            pairs.append((a, mutate(rng, a, 0.12)))
            ers = 0.06 + rng.random() * 0.1
            opens.append(2 if ers > 0.1 else 3)
            ks.append(kset[t % 3])
            mids.append(math.floor((1.0 - ers) * ks[-1]))
        assert_oracle(pairs, opens, ks, mids)

    def test_terminal_gaps_and_short_alignments(self, rng):
        a = rand_seq(rng, 150)
        b = np.concatenate([rand_seq(rng, 30), a[40:90], rand_seq(rng, 60)])
        pairs = [(a, b), (b, a), (rand_seq(rng, 12), rand_seq(rng, 120)),
                 (rand_seq(rng, 5), rand_seq(rng, 6))]
        assert_oracle(pairs, [3, 3, 2, 5], [13, 13, 13, 20], [11, 11, -3, 10])

    def test_banded_paths_inside_the_band(self, rng):
        # related pairs whose optimal paths stay in the band: banded == full
        pairs, opens, ks, mids = [], [], [], []
        for lo, hi in ((80, 150), (300, 500), (600, 900)):
            for _ in range(3):
                a = rand_seq(rng, int(rng.integers(lo, hi)))
                pairs.append((a, mutate(rng, a, 0.12)))
                opens.append(int(rng.choice([2, 3, 4, 5])))
                ks.append(int(rng.choice([13, 15, 20])))
                mids.append(int(rng.integers(5, 13)))
        assert_oracle(pairs, opens, ks, mids, band=150)

    def test_block_and_identity_wrappers(self, rng):
        pairs = [(rand_seq(rng, 80), mutate(rng, rand_seq(rng, 80), 0.1))
                 for _ in range(4)]
        got = port.block_stats_torch(pairs, [4] * 4, [13] * 4, [11] * 4,
                                     device=CPU)
        ident = port.identity_torch(pairs, [3] * 4, device=CPU)
        for i, (a, b) in enumerate(pairs):
            r1, r2, _ = oracle(a, b, 4, 13, 11)
            assert got[i] == pytest.approx((r1, r2), abs=0.0)
            assert ident[i] == pytest.approx(
                identity_from_moves(sg_align_numpy(a, b, 3), a, b), abs=0.0)


def test_out_of_band_matches_pallas_interpret(rng):
    # unrelated pairs at band 8: optimal paths leave the band, so the
    # semantics of out-of-band cells (unreachable H, free-running E/F inside
    # the window) decide the result.  One interpret-mode call pins them.
    pairs, opens, ks, mids = [], [], [], []
    for t in range(8):
        pairs.append((rand_seq(rng, int(rng.integers(70, 120))),
                      rand_seq(rng, int(rng.integers(70, 120)))))
        opens.append(int(rng.choice([2, 3, 5])))
        ks.append((13, 20, 26, 30)[t % 4])
        mids.append(int(rng.integers(-1, 12)))
    want = ref.sg_stats_batch_pallas(pairs, opens, ks, mids, band=8,
                                     interpret=True)
    got = port.sg_stats_batch_torch(pairs, opens, ks, mids, band=8,
                                    device=CPU)
    assert got == pytest.approx(want, abs=0.0)


@pytest.mark.parametrize("band", [0, 50, 150, 300])
def test_window_schedule_equals_reference(rng, band):
    for _ in range(10):
        B = int(rng.integers(1, 9))
        len1 = rng.integers(50, 1200, size=B)
        len2 = rng.integers(50, 1200, size=B)
        n = port_align._bucket_width(int(len1.max()))
        m = port_align._bucket_width(int(len2.max()))
        base, W = port._window_schedule_raw(
            len1, len2, n, m, band,
            (int(len1.min()), int(len1.max()), int(len2.min()),
             int(len2.max()), n, m, band))
        want_base, want_W = ref._window_schedule(len1, len2, n, m, band)
        assert W == want_W
        assert np.array_equal(base, want_base)


@pytest.mark.parametrize("band", [0, 150])
def test_gather_chunk_equals_reference(rng, band):
    # raw endpoint rows from a real run, plus synthetic ones covering the
    # empty-band endpoint (negative scores) and long trailing gaps
    pairs = [(rand_seq(rng, int(rng.integers(40, 160))),
              rand_seq(rng, int(rng.integers(40, 160)))) for _ in range(6)]
    seqs = [s for p in pairs for s in p]
    pool = port.SeqPool(CPU)
    pool.ensure(seqs)
    r1, r2 = list(range(0, 12, 2)), list(range(1, 12, 2))
    ks = [13, 20, 5, 30, 9, 13]
    mids = [9, 15, -2, 20, 0, 11]
    pm, base, W, d_max, len1, len2 = port.stage_chunk(
        pool, seqs, r1, r2, [3] * 6, ks, mids, band)
    rows = port.stats_rows(pool.buf, pm, base, W, d_max, band).numpy()
    synth = rows.copy()
    synth[:, 0] = rng.integers(-50, 40, size=6)
    synth[:, 8] = rng.integers(-50, 40, size=6)
    synth[:, 1] = rng.integers(0, len2 + 1)
    synth[:, 9] = rng.integers(0, len1 + 1)
    for raw in (rows, synth):
        args = (len1, len2, np.asarray(ks, np.int64),
                np.asarray(mids, np.int64), band)
        assert port._gather_chunk(raw.copy(), *args) == \
            ref._gather_chunk(raw.copy(), *args)


class TestWrapper:
    def test_plain_counts_launches_and_pairs(self, rng):
        port.reset_counts()
        pairs = [(rand_seq(rng, 50), rand_seq(rng, 60)) for _ in range(3)]
        port.sg_stats_batch_torch(pairs, [3] * 3, [13] * 3, [9] * 3,
                                  device=CPU)
        assert (port.PLAIN_LAUNCHES, port.PLAIN_PAIRS) == (1, 3)
        assert (port.LAUNCHES, port.PAIRS) == (0, 0)

    def test_rejects_malformed_inputs(self):
        pool = torch.zeros(64, dtype=torch.uint8)
        pm = torch.ones((2, 8), dtype=torch.int64)
        base = torch.zeros(16, dtype=torch.int32)
        port.stats_rows(pool, pm, base, 128, 15, 0)
        with pytest.raises(ValueError):
            port.stats_rows(pool.to(torch.int32), pm, base, 128, 15, 0)
        with pytest.raises(ValueError):
            port.stats_rows(pool, pm.to(torch.int32), base, 128, 15, 0)
        with pytest.raises(ValueError):
            port.stats_rows(pool, pm[:, :7].contiguous(), base, 128, 15, 0)
        with pytest.raises(ValueError):
            port.stats_rows(pool, pm, base, 128, 16, 0)   # base too short
        with pytest.raises(ValueError):
            port.stats_rows(pool, pm, base[::2], 128, 7, 0)
        with pytest.raises(ValueError):
            port.sg_stats_pool_torch([pool.numpy()], [0], [0], [3], [31],
                                     [9], device=CPU)

    def test_pool_growth_keeps_offsets(self, rng):
        pool = port.SeqPool(CPU)
        rows = []
        for _ in range(12):
            rows.append(rand_seq(rng, int(rng.integers(200_000, 900_000))))
            pool.ensure(rows[-2:])          # one resident, one new row
        assert pool.buf.numel() > port.SeqPool.CAP_MIN
        buf = pool.buf.numpy()
        for r in rows:
            off = pool.offset(r)
            assert np.array_equal(buf[off: off + r.size], r)

    def test_concurrent_ensure_keeps_every_row(self, rng):
        """8 threads (ranks that run as threads share the process's pool)
        each ensure 200 distinct rows, two per call, released together by a
        barrier and switching often: every row must sit at its recorded offset, in the buffer
        its own ensure returned and in the final one, and no two rows may
        overlap."""
        threads, per_thread = 8, 200
        pool = port.SeqPool(CPU)
        rows = [[rand_seq(rng, int(rng.integers(2_000, 30_000)))
                 for _ in range(per_thread)] for _ in range(threads)]
        start = threading.Barrier(threads)
        held, errors = [[] for _ in range(threads)], []

        def worker(t):
            try:
                start.wait()
                for i in range(0, per_thread, 2):
                    part = rows[t][i: i + 2]
                    buf = pool.ensure(part)
                    held[t].append((part, buf, pool.offsets(part)))
            except BaseException as e:       # surfaced below
                errors.append(e)

        workers = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in range(threads)]
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)          # switch threads often
        try:
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=120)
        finally:
            sys.setswitchinterval(switch)
        assert not any(w.is_alive() for w in workers)
        assert not errors, errors
        assert pool.buf.numel() > port.SeqPool.CAP_MIN   # it grew meanwhile
        final = pool.buf.numpy()
        spans = []
        for t in range(threads):
            for part, buf, offs in held[t]:
                for r, off in zip(part, offs.tolist()):
                    assert np.array_equal(buf.numpy()[off: off + r.size], r)
                    assert np.array_equal(final[off: off + r.size], r)
                    spans.append((off, off + r.size))
        spans.sort()
        assert len(spans) == threads * per_thread
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


class TestBackendChoice:
    def test_default_is_cuda_and_env_overrides(self, monkeypatch):
        monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
        assert port_device.stats_backend_default() == "cuda"
        for name in port_device.BACKENDS:
            monkeypatch.setenv("NGSID_STATS_BACKEND", name.upper())
            assert port_device.stats_backend_default() == name
        monkeypatch.setenv("NGSID_STATS_BACKEND", "pallas")
        with pytest.raises(ValueError):
            port_device.stats_backend_default()

    def test_cuda_without_a_gpu_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_device.stats_device("cuda")
        assert port_device.stats_device("torch") == CPU

    @pytest.mark.parametrize("fn", ["pool", "batch", "block", "identity"])
    def test_entry_points_default_to_the_backends_device(self, rng,
                                                         monkeypatch, fn):
        # device=None: cuda:0 under the default backend, which raises with
        # no GPU; the CPU only when the backend asks for it
        pairs = [(rand_seq(rng, 40), rand_seq(rng, 50)) for _ in range(2)]
        calls = {
            "pool": lambda: port.sg_stats_pool_torch(
                [a for p in pairs for a in p], [0, 2], [1, 3], [3, 3],
                [13, 13], [9, 9]),
            "batch": lambda: port.sg_stats_batch_torch(pairs, [3, 3],
                                                       [13, 13], [9, 9]),
            "block": lambda: port.block_stats_torch(pairs, [3, 3], [13, 13],
                                                    [9, 9]),
            "identity": lambda: port.identity_torch(pairs, [3, 3]),
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

    @pytest.mark.parametrize("fn", ["block", "identity"])
    def test_dispatch_backends_agree(self, rng, fn):
        from ngspeciesid_tpu import native

        pairs = [(rand_seq(rng, int(rng.integers(60, 140))),) for _ in range(5)]
        pairs = [(a, mutate(rng, a, 0.1)) for (a,) in pairs]
        backends = ["torch", "host"] + (["native"] if native.available() else [])
        out = {}
        for b in backends:
            if fn == "block":
                out[b] = port_align.block_stats_batch(
                    pairs, [3] * 5, [13] * 5, [10] * 5, band=150, backend=b)
            else:
                out[b] = port_align.identity_batch(pairs, [3] * 5, band=150,
                                                   backend=b)
        for b in backends[1:]:
            assert out[b] == pytest.approx(out["torch"], abs=0.0), b
