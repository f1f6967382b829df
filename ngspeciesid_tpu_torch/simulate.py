"""Synthetic amplicon pool generator (test/bench fixtures).

A copy of scripts/simulate_reads.py inside the port: the same RNG calls in
the same order, so one seed writes the same pool byte for byte.

Replaces the reference's stripped multi-species fixture
(test/Supplementary_File1_reads.fastq, 3,000 reads / 3 fish species — listed
in .MISSING_LARGE_BLOBS) with a reproducible simulator: random species
templates (optionally flanked by primers from a fasta), ONT-like indel/sub
errors, both orientations, phred-realistic quality strings.

Usage:
  python -m ngspeciesid_tpu_torch.simulate --out pool.fastq --n_reads 3000 \
      --n_species 3 --length 700 [--primer_file primers.fa] [--error 0.07]
"""

import argparse

import numpy as np

from .io.fastx import read_fastx
from .utils.seqs import reverse_complement

ACGT = "ACGT"
IUPAC_CONCRETE = {
    "A": "A", "C": "C", "G": "G", "T": "T", "M": "AC", "R": "AG", "W": "AT",
    "S": "CG", "Y": "CT", "K": "GT", "V": "ACG", "H": "ACT", "D": "AGT",
    "B": "CGT", "N": "ACGT", "X": "ACGT",
}


def concretize(rng, primer: str) -> str:
    return "".join(IUPAC_CONCRETE[c][rng.integers(0, len(IUPAC_CONCRETE[c]))]
                   for c in primer.upper())


def noisy(rng, template: str, e: float):
    seq, qual = noisy_arrays(rng, np.frombuffer(template.encode(), np.uint8), e)
    return seq.tobytes().decode(), qual.tobytes().decode()


_ACGT_B = np.frombuffer(b"ACGT", np.uint8)


def noisy_arrays(rng, template: np.ndarray, e: float):
    """Vectorized ONT-style indel/sub noise (same per-base error model as
    the scalar generator: del e/3, ins e/3, sub e/3)."""
    n = template.size
    r = rng.random(n)
    keep = r >= e / 3
    ins = keep & (r < 2 * e / 3)
    sub = keep & (r >= 2 * e / 3) & (r < e)
    kept = template.copy()
    if sub.any():
        kept[sub] = _ACGT_B[rng.integers(0, 4, size=int(sub.sum()))]
    emit = keep.astype(np.int64) + ins          # bases emitted per template pos
    total = int(emit.sum())
    out = np.empty(total, dtype=np.uint8)
    pos = np.cumsum(emit) - emit                # output offset per template pos
    out[pos[keep]] = kept[keep]
    if ins.any():
        out[pos[ins] + 1] = _ACGT_B[rng.integers(0, 4, size=int(ins.sum()))]
    qual = rng.integers(33 + 8, 33 + 28, size=total).astype(np.uint8)
    return out, qual


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n_reads", type=int, default=3000)
    ap.add_argument("--n_species", type=int, default=3)
    ap.add_argument("--length", type=int, default=700)
    ap.add_argument("--error", type=float, default=0.07)
    ap.add_argument("--primer_file", default="")
    ap.add_argument("--both_orientations", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--truth_out", default="",
                    help="optional TSV acc<TAB>species for eval")
    args = ap.parse_args()

    rng = np.random.default_rng(args.seed)
    fw_primer = rv_primer = ""
    if args.primer_file:
        primers = [seq for _, seq, _ in read_fastx(args.primer_file)]
        fw_primer = concretize(rng, primers[0])
        if len(primers) > 1:
            rv_primer = reverse_complement(concretize(rng, primers[1]))

    templates = []
    for s in range(args.n_species):
        core = "".join(ACGT[c] for c in rng.integers(0, 4, size=args.length))
        templates.append(fw_primer + core + rv_primer)

    template_arrs = [np.frombuffer(t.encode(), np.uint8) for t in templates]
    truth = []
    with open(args.out, "wb") as f:
        parts = []
        for i in range(args.n_reads):
            sp = int(rng.integers(0, args.n_species))
            seq, qual = noisy_arrays(rng, template_arrs[sp], args.error)
            if args.both_orientations and rng.random() < 0.5:
                seq = np.frombuffer(
                    reverse_complement(seq.tobytes().decode()).encode(), np.uint8)
                qual = qual[::-1]
            acc = f"sim_{i}_sp{sp}".encode()
            parts.append(b"@" + acc + b"\n" + seq.tobytes() + b"\n+\n"
                         + qual.tobytes() + b"\n")
            truth.append((acc.decode(), sp))
            if len(parts) >= 4096:
                f.write(b"".join(parts))
                parts = []
        f.write(b"".join(parts))
    if args.truth_out:
        with open(args.truth_out, "w") as f:
            for acc, sp in truth:
                f.write(f"{acc}\t{sp}\n")
    print(f"wrote {args.out}: {args.n_reads} reads, {args.n_species} species")


if __name__ == "__main__":
    main()
