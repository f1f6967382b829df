"""Seeded amplicon libraries: the benchmark's one traffic generator.

A configuration's ``library`` block says what a library looks like; this
module turns it, the run's seed and a library's index into the fastq bytes
that the program reads, and into the truth that the check reads (the
species of every read and each species' core).

It follows ``ngspeciesid_tpu_torch/simulate.py`` (random ACGT cores, an
optional primer pair around them, ONT-like errors at rate e split evenly
into deletions, insertions and substitutions, both orientations, phred
8-27 quality strings), vectorised over the whole library instead of a
Python loop per read, and extended with:

* a species tree: a root core, genus ancestors mutated from it and
  species mutated from their genus ancestor, so that congeneric species
  are ``species_divergence`` apart and genus ancestors
  ``genus_divergence`` apart (edits per core base; substitutions, and
  codon indels for ``indel_share`` of the edits);
* abundances: Zipf over species rank (``kind: mixture``, one mixed
  library), or one dominant species and up to two minor ones per sample
  (``kind: plate``, a plate of samples of log-uniform sizes).

The seed draws every base: the cores, where the edits fall, the reads and
their errors, and the order of a plate's samples.  It never draws the
shape: genus sizes, divergences, abundances, sample sizes and sample
compositions are fixed grids of the configuration, so that every seed
asks for the same work, in another order and on other sequences.  A
plate's samples come in an order that is stratified by size, so that every
prefix of the run holds the plate's mix of sizes.

Everything is drawn from ``(seed, stream, index)``: the same triple gives
the same bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTacgtN", b"TGCAtgcaN"):
    _COMP[_a] = _b

#: Streams of the generator's random numbers: each kind of draw has its own,
#: so that adding one kind of draw never shifts another.
POOL, LIBRARY, ORDER, WARMUP = 1, 2, 3, 4


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    """The generator of one stream of draws (any integer seed)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream, index])


def revcomp(seq: np.ndarray) -> np.ndarray:
    return _COMP[seq[::-1]]


def mutate(g: np.random.Generator, parent: np.ndarray, divergence: float,
           indel_share: float) -> np.ndarray:
    """A copy of ``parent`` with ``round(divergence * len)`` base edits at
    distinct positions: substitutions to another base, and, for about
    ``indel_share`` of the edits, codon (3-base) deletions or insertions."""
    n = parent.size
    edits = int(round(divergence * n))
    n_indel = int(g.binomial(edits // 3, indel_share)) if indel_share else 0
    n_sub = edits - 3 * n_indel
    pos = g.choice(n - 3, size=n_sub + n_indel, replace=False)
    sub_pos, indel_pos = pos[:n_sub], np.sort(pos[n_sub:])
    child = parent.copy()
    child[sub_pos] = ACGT[(np.searchsorted(ACGT, child[sub_pos])
                           + g.integers(1, 4, size=n_sub)) % 4]
    if n_indel:
        is_del = g.random(n_indel) < 0.5
        # right to left, so that an edit never moves a position still due
        for p, d in sorted(zip(indel_pos.tolist(), is_del.tolist()),
                           reverse=True):
            child = (np.delete(child, np.s_[p: p + 3]) if d else
                     np.insert(child, p, ACGT[g.integers(0, 4, size=3)]))
    return child


@dataclass
class Pool:
    """The species of a configuration: their cores and their genera."""
    cores: List[np.ndarray]
    genus: np.ndarray
    ancestors: List[np.ndarray]
    primers: Sequence[str] = ()

    def template(self, sp: int) -> np.ndarray:
        """The amplicon of species ``sp``: the forward primer, the core and
        the reverse primer's reverse complement."""
        if not self.primers:
            return self.cores[sp]
        fw = np.frombuffer(self.primers[0].encode(), np.uint8)
        rv = revcomp(np.frombuffer(self.primers[1].encode(), np.uint8))
        return np.concatenate([fw, self.cores[sp], rv])


def grid(lo: float, hi: float, n: int) -> np.ndarray:
    """n values spread evenly over [lo, hi] (cell midpoints)."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / max(n, 1)


def genus_sizes(lib: dict) -> List[int]:
    """Genus sizes: ``genus_size`` each, or cycling lo, lo + 1, ..., hi."""
    n_species, gs = int(lib["species"]), lib["genus_size"]
    cycle = [int(gs)] if isinstance(gs, int) else list(range(gs[0], gs[1] + 1))
    sizes: List[int] = []
    while sum(sizes) < n_species:
        sizes.append(cycle[len(sizes) % len(cycle)])
    sizes[-1] -= sum(sizes) - n_species
    if sizes[-1] < cycle[0] and len(sizes) > 1:
        last = sizes.pop()
        sizes[-1] += last
    return sizes


def make_pool(g: np.random.Generator, lib: dict) -> Pool:
    """A species tree of ``lib["species"]`` species: genus g's ancestor
    differs from the root by the g-th step of half the genus divergence's
    range, and a genus's p-th species from its ancestor by the p-th step of
    half the species divergence's range, so that two of them are about the
    sum apart.  Only the bases and the edits' places are drawn."""
    length = int(lib["core_length"])
    share = float(lib.get("indel_share", 0.0))
    sizes = genus_sizes(lib)
    root = ACGT[g.integers(0, 4, size=length)]
    g_lo, g_hi = lib["genus_divergence"]
    s_lo, s_hi = lib["species_divergence"]
    ancestors, cores, genus = [], [], []
    for gi, (size, d_g) in enumerate(zip(sizes, grid(g_lo / 2, g_hi / 2,
                                                     len(sizes)))):
        anc = mutate(g, root, d_g, share)
        ancestors.append(anc)
        for d_s in grid(s_lo / 2, s_hi / 2, size):
            cores.append(mutate(g, anc, d_s, share))
            genus.append(gi)
    return Pool(cores, np.asarray(genus), ancestors,
                tuple(lib.get("primers", ())))


def zipf_counts(n_reads: int, n_species: int, exponent: float) -> np.ndarray:
    """Reads per species rank under Zipf's law, summing to ``n_reads``."""
    w = 1.0 / np.arange(1, n_species + 1) ** exponent
    exact = n_reads * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    short = n_reads - int(counts.sum())
    counts[np.argsort(counts - exact, kind="stable")[:short]] += 1
    return counts


def plate_sizes(lib: dict) -> np.ndarray:
    """The reads of a plate's samples: fixed quantiles of a log-uniform law
    on [reads_min, reads_max]."""
    n = int(lib["samples"])
    lo, hi = math.log(lib["reads_min"]), math.log(lib["reads_max"])
    return np.rint(np.exp(lo + (hi - lo) * (np.arange(n) + 0.5) / n)
                   ).astype(np.int64)


@dataclass
class Library:
    """One library: its fastq bytes and its truth."""
    fastq: bytes
    species: np.ndarray                  # species of each read, in file order
    pool: Pool

    @property
    def n_reads(self) -> int:
        return int(self.species.size)


def noisy_reads(g: np.random.Generator, templates: List[np.ndarray],
                species: np.ndarray, error: float, both: bool):
    """Every read's bases and qualities at once: each read's template (on
    the reverse strand for half of the reads when ``both``) laid end to
    end, and the error model applied to every base.  Returns the flat
    bases, flat qualities and each read's end offset."""
    strands = templates + [revcomp(t) for t in templates]
    lens = np.array([t.size for t in strands], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    buf = np.concatenate(strands)
    which = species + (len(templates) * (g.random(species.size) < 0.5)
                       if both else 0)
    rl = lens[which]
    first = np.cumsum(rl) - rl
    idx = np.arange(int(rl.sum()), dtype=np.int64)
    idx += np.repeat(starts[which] - first, rl)
    flat = buf[idx]
    r = g.random(flat.size, dtype=np.float32)
    keep = r >= np.float32(error / 3)
    ins = keep & (r < np.float32(2 * error / 3))
    sub = np.flatnonzero(keep & (r >= np.float32(2 * error / 3))
                         & (r < np.float32(error)))
    flat[sub] = ACGT[g.integers(0, 4, size=sub.size)]
    emit = keep.view(np.uint8) + ins.view(np.uint8)
    csum = np.cumsum(emit, dtype=np.int32)
    out = np.empty(int(csum[-1]) if csum.size else 0, np.uint8)
    pos = csum - emit
    out[pos[keep]] = flat[keep]
    ins_at = pos[ins] + 1
    out[ins_at] = ACGT[g.integers(0, 4, size=ins_at.size)]
    # phred 8-27: 20 values from one random byte each
    qual = (33 + 8 + ((g.integers(0, 256, size=out.size, dtype=np.uint8)
                       .astype(np.uint16) * 20) >> 8)).astype(np.uint8)
    ends = csum[np.cumsum(rl) - 1] if rl.size else np.zeros(0, np.int64)
    return out, qual, ends


def fastq_bytes(bases: np.ndarray, qual: np.ndarray, ends: np.ndarray,
                prefix: str) -> bytes:
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    b, q = bases.tobytes(), qual.tobytes()
    return b"".join(b"@%s_%d\n%s\n+\n%s\n" % (prefix.encode(), i, b[s:e],
                                               q[s:e])
                    for i, (s, e) in enumerate(zip(starts.tolist(),
                                                   ends.tolist())))


def stratified_order(g: np.random.Generator, n: int, stratum: int = 8
                     ) -> np.ndarray:
    """An order of n samples, given in ascending size, in which every
    prefix holds each size stratum (``stratum`` neighbouring sizes) about
    equally: round r takes one sample of every stratum, strata in a drawn
    order, each stratum's samples in a drawn order."""
    strata = [g.permutation(np.arange(a, min(a + stratum, n)))
              for a in range(0, n, stratum)]
    out = []
    for r in range(stratum):
        for k in g.permutation(len(strata)):
            if r < strata[k].size:
                out.append(int(strata[k][r]))
    return np.asarray(out, np.int64)


def _position_in_genus(genus: np.ndarray) -> np.ndarray:
    first = np.searchsorted(genus, genus)
    return np.arange(genus.size) - first


class Generator:
    """The libraries of one run of one configuration."""

    def __init__(self, lib: dict, seed: int) -> None:
        self.lib = lib
        self.seed = int(seed)
        self.kind = lib["kind"]
        if self.kind not in ("plate", "mixture"):
            raise ValueError(f"unknown library kind {self.kind!r}")
        # a plate shares one species pool; a mixture draws its own per library
        self.pool = (make_pool(rng(seed, POOL), lib)
                     if self.kind == "plate" else None)
        if self.kind == "plate":
            self.sizes = plate_sizes(lib)
            self.order = stratified_order(rng(seed, ORDER), self.sizes.size)

    def counts(self, n_reads: int, sample: int, genus: np.ndarray
               ) -> np.ndarray:
        """Reads of each species of the pool in one library: Zipf by rank,
        ranks dealt one genus after another (``mixture``), or a plate
        sample's fixed composition (``plate``): sample j has j % 3 minor
        species, a congener of its dominant species j and a species of the
        next genus, at shares on a grid over ``minor_share``."""
        lib = self.lib
        n_species = genus.size
        counts = np.zeros(n_species, np.int64)
        if self.kind == "mixture":
            by_rank = np.lexsort((genus, _position_in_genus(genus)))
            counts[by_rank] = zipf_counts(n_reads, n_species,
                                          float(lib["zipf_exponent"]))
            return counts
        lo, hi = lib["minor_share"]
        n_minor = min(sample % 3, lib["minor_count"][1])
        dom = sample % n_species
        same = np.flatnonzero(genus == genus[dom])
        mate = int(same[(np.searchsorted(same, dom) + 1) % same.size])
        other = int(np.flatnonzero(genus == (genus[dom] + 1) % (genus.max() + 1))[0])
        shares = grid(lo, hi, 7)[[(5 * sample) % 7, (5 * sample + 3) % 7]]
        for sp, share in list(zip([mate, other], shares))[:n_minor]:
            if sp != dom:
                counts[sp] += int(share * n_reads)
        counts[dom] = n_reads - int(counts.sum())
        return counts

    def library(self, index: int, n_reads: Optional[int] = None,
                stream: int = LIBRARY) -> Library:
        """Library ``index`` of the run (``n_reads``: its size, default the
        configuration's, or its plate sample's)."""
        lib = self.lib
        g = rng(self.seed, stream, index)
        pool = self.pool if self.pool is not None else make_pool(g, lib)
        sample = int(self.order[index % self.order.size]) \
            if self.kind == "plate" else 0
        if n_reads is None:
            n_reads = (int(self.sizes[sample]) if self.kind == "plate"
                       else int(lib["reads"]))
        counts = self.counts(n_reads, sample, pool.genus)
        species = g.permutation(np.repeat(np.arange(counts.size), counts))
        templates = [pool.template(s) for s in range(len(pool.cores))]
        bases, qual, ends = noisy_reads(g, templates, species,
                                        float(lib["error"]),
                                        bool(lib.get("both_orientations",
                                                     True)))
        return Library(fastq_bytes(bases, qual, ends, f"lib{index}"),
                       species, pool)

    def warmup(self) -> Library:
        """The set-up's small library of the same shape."""
        return self.library(0, int(self.lib["warmup_reads"]), stream=WARMUP)
