"""The port's full DP (ngspeciesid_tpu_torch.ops.align_full) against the
JAX package.

On the CPU the port runs the full-DP kernel's plain PyTorch version.  Its
moves (``moves[:, :n+m, :n+1]``) and endpoint rows (``best[:, :4]``) must
equal, bit for bit, those of the Pallas ``_kernel`` through ``_pallas_dp``
in interpret mode on the same batch; and the op streams of
``sg_align_batch_full(device=cpu)`` must equal both
``sg_align_batch_pallas(interpret=True)`` and the port's numpy oracle.
Tolerance: none, every comparison is exact.  The CUDA kernel is held
against the same plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ngspeciesid_tpu.ops import align_pallas as ref
from ngspeciesid_tpu_torch.ops import align_full as port
from ngspeciesid_tpu_torch.ops.align import sg_align_batch

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
    moves, best = port.full_dp_rows(*port.stage_pairs(pairs, opens, CPU), **sc)
    assert moves.dtype == torch.uint8 and best.dtype == torch.int32
    assert tuple(moves.shape) == (len(pairs), n + m, port.lanes_for(n))
    got = moves.numpy().astype(np.int32)
    assert np.array_equal(got[:, : n + m, : n + 1],
                          want_moves[:, : n + m, : n + 1])
    assert not got[:, :, n + 1:].any()
    assert np.array_equal(best.numpy(), want_best[:, :4])

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
    monkeypatch.setattr(port, "MAX_STORE_BYTES", 3 * (30 + 33) * 128)
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


def test_wrapper_refuses_bad_inputs():
    s1 = torch.zeros((2, 5), dtype=torch.uint8)
    s2 = torch.zeros((2, 7), dtype=torch.uint8)
    with pytest.raises(ValueError, match="meta"):
        port.full_dp_rows(s1, s2, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        port.full_dp_rows(s1.int(), s2, torch.zeros((2, 3), dtype=torch.int32))
