"""The port's full DP (ngspeciesid_tpu_torch.ops.align_full) against the
JAX package.

On the CPU the port runs the full-DP kernel's plain PyTorch version, the
moves DP's plain version in the fixed full frame.  Its move store (masked
to the interior cells) and endpoint rows must equal, bit for bit, the raw
move words and ``best[:, :4]`` of the Pallas ``_kernel`` through
``_pallas_dp`` in interpret mode on the same batch; and the op streams of
``sg_align_batch_full(device=cpu)``, reconstructed from the plain
version's ``best`` and ``ops``, must equal both
``sg_align_batch_pallas(interpret=True)`` and the port's numpy oracle.
Tolerance: none, every comparison is exact.  The CUDA kernel is held
against the same plain version on the card by chip_smoke.py, and its
source under a CPU emulation by tests/test_torch_cuda_emulated.py.
"""

import numpy as np
import pytest
import torch

from ngspeciesid_tpu.ops import align_pallas as ref
from ngspeciesid_tpu_torch.ops import align_full as port
from ngspeciesid_tpu_torch.ops.align import sg_align_batch
from ngspeciesid_tpu_torch.ops.align_moves import moves_plain

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


def random_pairs(rng):
    pairs = [(rand_seq(rng, int(rng.integers(8, 90))),
              rand_seq(rng, int(rng.integers(8, 90)))) for _ in range(10)]
    return pairs, [int(rng.choice([2, 3, 5])) for _ in pairs]


def related_pairs(rng):
    pairs = []
    for _ in range(8):
        a = rand_seq(rng, int(rng.integers(40, 120)))
        b = mutate(rng, a, 0.15)
        pairs.append((a, b if b.size >= 5 else rand_seq(rng, 20)))
    return pairs, [2] * len(pairs)


def asymmetric_pairs(rng):
    return [(rand_seq(rng, 6), rand_seq(rng, 200)),
            (rand_seq(rng, 200), rand_seq(rng, 6))], [5, 5]


def batch_of_11(rng):
    return [(rand_seq(rng, 30), rand_seq(rng, 33)) for _ in range(11)], [3] * 11


CASES = {"random": (random_pairs, {}), "related": (related_pairs, {}),
         "asymmetric": (asymmetric_pairs, {}), "batch11": (batch_of_11, {}),
         "poa": (related_pairs, dict(POA, open=2))}


def pallas_rows(pairs, opens, match, mismatch, gap_ext):
    """moves and best of the interpreted Pallas kernel, staged as
    sg_align_batch_pallas stages them."""
    import jax.numpy as jnp

    n = max(a.size for a, _ in pairs)
    m = max(b.size for _, b in pairs)
    L = -(-(n + 1) // 128) * 128
    Bp = -(-len(pairs) // ref.SUBLANES) * ref.SUBLANES
    s2r_w = -(-(n + m + L) // 128) * 128
    s1b = np.zeros((Bp, L), dtype=np.int32)
    s2r = np.full((Bp, s2r_w), -1, dtype=np.int32)
    meta = np.ones((Bp, ref.BEST_W), dtype=np.int32)
    meta[:, 2] = 5
    for i, (a, b) in enumerate(pairs):
        s1b[i, : a.size] = a
        s2r[i, n + m - b.size: n + m] = b[::-1]
        meta[i, :3] = (a.size, b.size, opens[i])
    moves, best = ref._pallas_dp(
        jnp.asarray(meta), jnp.asarray(s1b), jnp.asarray(s2r), n=n, m=m, L=L,
        match=match, mismatch=mismatch, gap_ext=gap_ext, interpret=True)
    return np.asarray(moves)[: len(pairs)], np.asarray(best)[: len(pairs)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_dp_bit_equal_to_pallas(rng, case):
    make, scoring = CASES[case]
    pairs, opens = make(rng)
    scoring = dict(scoring)
    if "open" in scoring:
        opens = [scoring.pop("open")] * len(pairs)
    sc = {**dict(match=2, mismatch=-2, gap_ext=1), **scoring}
    n = max(a.size for a, _ in pairs)
    m = max(b.size for _, b in pairs)

    want_moves, want_best = pallas_rows(pairs, opens, **sc)
    pool, pm, W, d_max, _, _ = port.stage_pairs(pairs, opens, CPU)
    assert (W, d_max) == (port.lanes_for(n), n + m)
    base = torch.zeros(d_max + 1, dtype=torch.int32)
    best, ops, store = moves_plain(pool, pm, base, W, d_max, 0, **sc)
    assert store.dtype == torch.uint8 and best.dtype == torch.int32
    assert tuple(store.shape) == (len(pairs), n + m + 1, W)
    # cell (i, j) of diagonal dd = i + j: the store's [dd, i], the Pallas
    # kernel's [dd - 1, i] (0 outside the interior cells)
    i = np.arange(n + 1)[None, None, :]
    j = np.arange(1, n + m + 1)[None, :, None] - i
    len1 = pm[:, 0].numpy()[:, None, None]
    len2 = pm[:, 1].numpy()[:, None, None]
    interior = (i >= 1) & (i <= len1) & (j >= 1) & (j <= len2)
    got = np.where(interior, store.numpy()[:, 1:, : n + 1].astype(np.int32), 0)
    assert np.array_equal(got, want_moves[:, : n + m, : n + 1])
    assert np.array_equal(best.numpy()[:, [0, 1, 8, 9]], want_best[:, :4])
    # the wrapper's plain version is the same DP and walk
    got_best, got_ops = port.full_dp_rows(pool, pm, W, d_max, **sc)
    assert torch.equal(got_best, best) and torch.equal(got_ops, ops)
    assert tuple(got_ops.shape) == (len(pairs), n + m + 1)

    port.reset_counts()
    streams = port.sg_align_batch_full(pairs, opens, device=CPU, **sc)
    assert (port.PLAIN_LAUNCHES, port.PLAIN_PAIRS) == (1, len(pairs))
    assert port.LAUNCHES == 0
    pallas = ref.sg_align_batch_pallas(pairs, opens, interpret=True, **sc)
    oracle = sg_align_batch(pairs, opens, backend="numpy", **sc)
    for g, p, o in zip(streams, pallas, oracle):
        assert g.dtype == np.uint8
        assert g.tolist() == p.tolist() == o.tolist()


def test_batch_is_chunked_under_the_store_cap(rng, monkeypatch):
    pairs, opens = batch_of_11(rng)
    want = port.sg_align_batch_full(pairs, opens, device=CPU)
    monkeypatch.setattr(port, "MAX_STORE_BYTES", 3 * (30 + 33 + 1) * 128)
    port.reset_counts()
    got = port.sg_align_batch_full(pairs, opens, device=CPU)
    assert port.PLAIN_LAUNCHES == 4
    assert [g.tolist() for g in got] == [w.tolist() for w in want]


def test_default_device_follows_the_backend(rng, monkeypatch):
    pairs, opens = batch_of_11(rng)
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    port.reset_counts()
    assert len(port.sg_align_batch_full(pairs[:2], opens[:2])) == 2
    assert port.PLAIN_LAUNCHES == 1
    monkeypatch.setenv("NGSID_STATS_BACKEND", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.sg_align_batch_full(pairs[:2], opens[:2])


def test_wrapper_refuses_bad_inputs(rng):
    pool, pm, W, d_max, _, _ = port.stage_pairs(*batch_of_11(rng), CPU)
    with pytest.raises(ValueError, match="pm"):
        port.full_dp_rows(pool, pm[:, :3].contiguous(), W, d_max)
    with pytest.raises(ValueError, match="pm"):
        port.full_dp_rows(pool, pm.int(), W, d_max)
    with pytest.raises(ValueError, match="pool"):
        port.full_dp_rows(pool.int(), pm, W, d_max)
    with pytest.raises(ValueError, match="multiple of 128"):
        port.full_dp_rows(pool, pm, W + 8, d_max)


def test_s1_above_8191_bytes(rng):
    """An s1 longer than 8,191 bytes (the cap of an earlier kernel of 8,192
    lanes) runs, as it does in sg_align_batch_pallas: on the card in memory
    mode (W 8320), here through the plain version."""
    a = rand_seq(rng, 8200)
    b = a[3000:3040].copy()
    b[::7] = rand_seq(rng, b[::7].size)
    pairs, opens = [(a, b)], [3]
    port.reset_counts()
    got = port.sg_align_batch_full(pairs, opens, device=CPU)
    assert (port.PLAIN_LAUNCHES, port.PLAIN_PAIRS) == (1, 1)
    want = sg_align_batch(pairs, opens, backend="numpy")
    assert got[0].tolist() == want[0].tolist()
