#!/usr/bin/env python
"""Monte-Carlo generator for the shared-minimizer probability table (C18).

Regenerates the empirical table shipped as ngspeciesid_tpu/data/p_minimizers.npz
from scratch: for each (k, w, e1, e2), two indel-mutated copies of a random
1000-nt template are homopolymer-compressed and the fraction of copy-1
minimizers found among copy-2's minimizers within +-500 positions is averaged
over replicates (the estimator defined by the reference's
scripts/compute_shared_minimizer_probabilities.py:108-188; here driven by the
framework's packed-code minimizer engine instead of string dictionaries).

Usage:
  python scripts/generate_p_table.py --out table.npz \
      [--k_min 10 --k_max 30] [--replicates 999] [--errors 0.01..0.15]
"""

import argparse
import itertools

import numpy as np

from .ops.minimizers import alphabet_ranks, sequence_minimizers
from .utils.seqs import hpol_compress_bytes

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
RANK_OF, RANK_BITS = alphabet_ranks(ACGT)


def mutate(rng, template: np.ndarray, e: float) -> np.ndarray:
    """Half deletions, half insertions, like the reference's generator."""
    keep = rng.random(template.size) > e / 2.0
    kept = template[keep]
    ins_mask = rng.random(kept.size) < e / 2.0
    n_ins = int(ins_mask.sum())
    if n_ins == 0:
        return kept
    ins_bases = ACGT[rng.integers(0, 4, size=n_ins)]
    out = np.empty(kept.size + n_ins, dtype=np.uint8)
    pos = np.flatnonzero(ins_mask)
    dest = np.arange(kept.size) + np.cumsum(ins_mask) - ins_mask
    out[dest] = kept
    out[pos + np.arange(1, n_ins + 1)] = ins_bases
    return out


def shared_fraction(k, w, r1c, r2c):
    if r1c.size < k or r2c.size < k:
        return 0.0
    c1, p1 = sequence_minimizers(r1c, k, w, RANK_OF, RANK_BITS)
    c2, p2 = sequence_minimizers(r2c, k, w, RANK_OF, RANK_BITS)
    if c1.size == 0:
        return 0.0
    # for each minimizer of read1: shared if read2 has the same code within
    # +-500 positions (reference estimator)
    order = np.argsort(c2, kind="stable")
    c2s, p2s = c2[order], p2[order]
    lo = np.searchsorted(c2s, c1, side="left")
    hi = np.searchsorted(c2s, c1, side="right")
    shared = 0
    for i in range(c1.size):
        if lo[i] < hi[i]:
            if np.any(np.abs(p2s[lo[i]:hi[i]] - p1[i]) < 500):
                shared += 1
    return shared / float(c1.size)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--k_min", type=int, default=10)
    ap.add_argument("--k_max", type=int, default=30)
    ap.add_argument("--replicates", type=int, default=999)
    ap.add_argument("--template_len", type=int, default=1000)
    ap.add_argument("--errors", type=str,
                    default=",".join(f"{e/100:.2f}" for e in range(1, 16)))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    errors = [float(e) for e in args.errors.split(",")]
    rng = np.random.default_rng(args.seed)
    ks, ws, ps, e1s, e2s = [], [], [], [], []
    for e1, e2 in itertools.combinations_with_replacement(sorted(errors, reverse=True), 2):
        for k in range(args.k_min, args.k_max + 1):
            for w in range(k, 101, 5):
                vals = []
                for _ in range(args.replicates):
                    t = ACGT[rng.integers(0, 4, size=args.template_len)]
                    r1 = hpol_compress_bytes(mutate(rng, t, e1))
                    r2 = hpol_compress_bytes(mutate(rng, t, e2))
                    vals.append(shared_fraction(k, w, r1, r2))
                ks.append(k)
                ws.append(w)
                ps.append(float(np.mean(vals)))
                e1s.append(e1)
                e2s.append(e2)
            print(f"k={k} e1={e1} e2={e2} done", flush=True)
    np.savez_compressed(args.out,
                        k=np.array(ks, np.int16), w=np.array(ws, np.int16),
                        p=np.array(ps), e1=np.array(e1s), e2=np.array(e2s))
    print(f"wrote {args.out}: {len(ks)} entries")


if __name__ == "__main__":
    main()
