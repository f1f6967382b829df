"""The roofline arithmetic: cells, bytes, the least time."""

import numpy as np
import pytest

from benchmark import roofline


def brute_cells(l1: int, l2: int, band: int) -> int:
    """In-band interior cells by walking every anti-diagonal's rows, with
    the band test as the DP states it."""
    n, tot = 0, l1 + l2
    for d in range(2, l1 + l2 + 1):
        for i in range(max(1, d - l2), min(l1, d - 1) + 1):
            if band <= 0 or ((d - band) * l1 <= i * tot
                             and i * tot < (d + band + 1) * l1):
                n += 1
    return n


@pytest.mark.parametrize("band", [0, 150, 7])
def test_band_cells_equal_a_brute_force_count(band):
    rng = np.random.default_rng(band)
    l1 = rng.integers(1, 90, 60)
    l2 = rng.integers(1, 90, 60)
    if band == 150:   # pairs long enough for the band to cut them
        l1, l2 = l1 * 4, l2 * 4
    got = roofline.band_cells(l1, l2, band)
    assert got.tolist() == [brute_cells(int(a), int(b), band)
                            for a, b in zip(l1, l2)]


def test_band_zero_is_the_whole_matrix_and_a_band_cuts_it():
    assert roofline.band_cells([700], [650], 0).tolist() == [700 * 650]
    banded = int(roofline.band_cells([700], [650], 150)[0])
    # each row holds at most 2 * 150 + 1 in-band cells
    assert 150 * 700 < banded <= 301 * 700


def test_bytes_and_least_time():
    assert roofline.pair_bytes("stats", [10], [20]).tolist() == [30 + 64]
    assert roofline.pair_bytes("moves", [10], [20]).tolist() == [30 + 64 + 31]
    l1, l2 = [700] * 512, [690] * 512
    cells = int(roofline.band_cells(l1, l2, 150).sum())
    want = cells * 13 / roofline.INT32_OPS_PER_S
    assert roofline.least_seconds("moves", l1, l2, 150) == pytest.approx(want)
    # a pair of one base each is bound by its bytes, not its one cell
    tiny = roofline.least_seconds("stats", [1], [1], 0)
    assert tiny == pytest.approx(66 / roofline.HBM_BYTES_PER_S)
    with pytest.raises(ValueError):
        roofline.pair_bytes("full", [1], [1])
