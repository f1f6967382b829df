"""The library generator: seeded, in its configured ranges, vectorised."""

import json
import os
import time

import numpy as np
import pytest

from benchmark import traffic

HERE = os.path.dirname(os.path.abspath(__file__))
#: Where each library block lives: a cell's configuration, or the tests'
#: own mixed library.
CONFIGS = {"coi_plate": os.path.join(os.path.dirname(HERE), "configs"),
           "mixture": os.path.join(HERE, "data")}


def library_block(name):
    with open(os.path.join(CONFIGS[name], f"{name}.json")) as f:
        return json.load(f)["library"]


def edit_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein distance, one row at a time."""
    j = np.arange(b.size + 1)
    prev = j.copy()
    for i in range(1, a.size + 1):
        t = np.empty(b.size + 1, np.int64)
        t[0] = i
        t[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        prev = np.minimum.accumulate(t - j) + j
    return int(prev[-1])


@pytest.mark.parametrize("name", ["coi_plate", "mixture"])
def test_same_seed_and_index_same_bytes(name):
    lib = library_block(name)
    if lib["kind"] == "mixture":
        lib = {**lib, "reads": 3000}
    seed = 2**31 + 977
    a = traffic.Generator(lib, seed).library(5)
    b = traffic.Generator(lib, seed).library(5)
    assert a.fastq == b.fastq and np.array_equal(a.species, b.species)
    assert traffic.Generator(lib, seed).library(6).fastq != a.fastq
    assert traffic.Generator(lib, seed + 1).library(5).fastq != a.fastq
    assert traffic.Generator(lib, seed).warmup().n_reads == lib["warmup_reads"]


@pytest.mark.parametrize("name", ["coi_plate", "mixture"])
def test_divergences_in_configured_ranges(name):
    """Congeneric species and genus ancestors are as far apart as configured
    (edits per core base; 2% slack below for edits that land on one
    position in both, or that an alignment can merge)."""
    lib = library_block(name)
    pool = traffic.make_pool(traffic.rng(12345, traffic.POOL), lib)
    n = lib["core_length"]
    lo, hi = lib["species_divergence"]
    genus = pool.genus
    pairs = [(a, b) for a in range(len(pool.cores)) for b in range(a + 1, len(pool.cores))
             if genus[a] == genus[b]][:12]
    for a, b in pairs:
        d = edit_distance(pool.cores[a], pool.cores[b]) / n
        assert lo - 0.02 <= d <= hi + 0.005, (a, b, d)
    g_lo, g_hi = lib["genus_divergence"]
    for a in range(3):
        d = edit_distance(pool.ancestors[a], pool.ancestors[a + 1]) / n
        assert g_lo - 0.03 <= d <= g_hi + 0.005, (a, d)
    gs = lib["genus_size"]
    lo, hi = (gs, gs) if isinstance(gs, int) else gs
    assert lo <= np.bincount(genus).min() and np.bincount(genus).max() <= hi
    assert np.bincount(genus).sum() == lib["species"]


def test_mixture_abundance_is_zipf():
    lib = library_block("mixture")
    out = traffic.Generator(lib, 99).library(0)
    counts = np.sort(np.bincount(out.species, minlength=lib["species"]))[::-1]
    want = traffic.zipf_counts(lib["reads"], lib["species"], lib["zipf_exponent"])
    assert np.array_equal(counts, np.sort(want)[::-1])
    assert counts.sum() == lib["reads"]
    cutoff = int(0.005 * lib["reads"])
    assert int((counts >= cutoff).sum()) == 44


def test_plate_samples_and_shares():
    lib = library_block("coi_plate")
    sizes = traffic.plate_sizes(lib)
    assert sizes.size == lib["samples"]
    assert sizes.min() >= lib["reads_min"] and sizes.max() <= lib["reads_max"]
    assert abs(sizes.mean() - 852) / 852 < 0.05
    g1 = traffic.Generator(lib, 1)
    for index in range(12):
        out = g1.library(index)
        counts = np.bincount(out.species)
        counts = counts[counts > 0]
        shares = np.sort(counts / counts.sum())[::-1]
        assert out.n_reads == sizes[g1.order[index]]
        assert shares[0] >= 0.70
        assert 1 <= shares.size <= 1 + lib["minor_count"][1]
        for s in shares[1:]:
            assert lib["minor_share"][0] - 1 / out.n_reads <= s <= lib["minor_share"][1]


def test_every_seed_asks_for_the_same_work():
    """The seed draws bases and order, never the shape: the plate's samples
    (size and composition) and a mixture's abundances are the same sets."""
    lib = library_block("coi_plate")
    shapes = []
    for seed in (1, 2**31 + 7):
        g = traffic.Generator(lib, seed)
        genus = g.pool.genus
        shapes.append(sorted((int(g.sizes[j]),
                              tuple(g.counts(int(g.sizes[j]), j, genus)[
                                  np.flatnonzero(g.counts(int(g.sizes[j]), j, genus))]))
                             for j in g.order))
    assert shapes[0] == shapes[1]
    assert list(traffic.Generator(lib, 1).order) != list(traffic.Generator(lib, 2).order)
    mix = {**library_block("mixture"), "reads": 2000}
    tallies = [sorted(np.bincount(traffic.Generator(mix, seed).library(0).species))
               for seed in (3, 4)]
    assert tallies[0] == tallies[1]


def test_every_prefix_of_a_plate_holds_its_mix_of_sizes():
    lib = library_block("coi_plate")
    g = traffic.Generator(lib, 11)
    stratum = np.asarray(g.order) // 8          # samples come by size
    n_strata = int(stratum.max()) + 1
    for k in range(1, 9):
        counts = np.bincount(stratum[: k * n_strata], minlength=n_strata)
        assert counts.min() == counts.max() == k


def test_reads_carry_the_error_rate_and_both_strands():
    lib = {**library_block("mixture"), "reads": 400}
    out = traffic.Generator(lib, 3).library(0)
    lines = out.fastq.split(b"\n")
    seqs = [np.frombuffer(lines[i + 1], np.uint8) for i in range(0, 4 * 60, 4)]
    forward = reverse = 0
    for seq, sp in zip(seqs, out.species[:60]):
        core = out.pool.cores[sp]
        fw = edit_distance(core, seq)
        rc = edit_distance(core, traffic.revcomp(seq))
        d = min(fw, rc) / core.size
        assert 0.03 <= d <= 0.11, d
        forward += fw < rc
        reverse += rc < fw
    assert forward >= 15 and reverse >= 15
    quals = np.frombuffer(b"".join(lines[3:4 * 60:4]), np.uint8)
    assert quals.min() >= 33 + 8 and quals.max() <= 33 + 27


def test_a_20k_read_library_takes_a_fraction_of_a_second_loop():
    """The port's simulator loops per read in Python (3.0 s for 20k reads
    on a CPU); this one is vectorised over the library."""
    lib = library_block("mixture")
    g = traffic.Generator(lib, 5)
    g.library(0)
    t0 = time.perf_counter()
    out = g.library(1)
    took = time.perf_counter() - t0
    assert out.n_reads == 20000
    assert took < 1.5, took
