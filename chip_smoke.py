#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ngspeciesid_tpu_torch) on one GPU.

Run from the repository root, with no arguments and no install:

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --times-only # phase 1, then 2d without the plain
                                       # versions and the full DP's entry point

``--times-only`` uses only the kernels' public wrappers and the full DP's
entry point, so a copy of this file run from an older checkout's root times
that checkout's kernels at the same shapes on the same seeds.

Phases, each fatal on failure:

1. Device and build: requires CUDA, builds csrc/*.cu with nvcc (one process
   per source, all at once), prints the build time, the ptxas report of
   the kernels and the card's name and power limit.
2. Each kernel against its plain PyTorch version, on the card:
   a. stats kernel: raw (B, 16) endpoint rows bit-equal on seeded pairs over
      lengths {90-120, 300-500, 500-800, 1100-1400}, k {13, 20, 26}, band
      {0, 150}, batch 8; at band 0 on two 2.5-3 kb pairs (W = 3200); on one
      pair of ~16.5 kb reads at band 150 and at band 0 (d_max >= 32768: the
      unpacked path fields, in register and in memory mode); and at the
      clustering path's shape (4096 pairs, ~700 bp, band 150, k 13).
      Chunks of up to 8 pairs run again under every launch geometry the
      kernel takes (each lane count, memory mode).  At band 0 the finalized
      statistics must also equal the numpy oracle.
   b. moves kernel: raw endpoint rows and op streams bit-equal over the
      same lengths and the 2.5-3 kb pairs at band 0, band {0, 150}, POA and
      clustering scoring, mutated and unrelated pairs, every geometry for
      small chunks.  At band 0 the reconstructed moves must also equal the
      numpy oracle.
   c. full-DP kernel (the moves wavefront in a fixed full frame, traced
      back on the card): endpoint rows and op streams bit-equal over
      lengths {8-90, 90-120, 300-500, 500-800, 1100-1400}, POA and
      clustering scoring, mutated and unrelated pairs, an 11-pair batch and
      one pair of ~8.5 kb reads (memory mode); chunks of up to 8 pairs
      under every launch geometry; op streams equal to the numpy oracle up
      to 500 bp and to the native band-0 DP at ~8.5 kb.  At the polish
      shape (one 700 bp center against 512 reads of 650-750 bp, POA
      scoring) it is timed (the forward sweep alone too) against its plain
      version and its bound, and its entry point's wall is split into
      staging, kernel, download and reconstruction; the entry point,
      sg_align_batch_full, runs once with the counts at 0 (its launches in
      the JSON line come from there), its op streams must equal the native
      engine's band-0 DP, and under torch.profiler only the endpoint rows
      and op streams may be copied to the host.
   d. times per launch (CUDA events, warm median) of the stats kernel at a
      4096-pair clustering wave and a 128-pair launch (~700 bp, band 150,
      k 13), and of the moves kernel at the polish shape (one ~700 bp
      center against 512 reads of 650-750 bp; band 150, POA scoring), a
      100-pair draft-sized launch of the same kind, and 256 and 512 reads
      of 520-880 bp (a 384-lane window, 3 warps a pair); both kernels
      also at band 0 on ~700 bp and ~1.4 kb reads (windows of 1152 and
      1664 lanes); each against its plain version (bit-equal there too)
      and its bound.
   e. the geometry sweep: the same shapes, and the full DP at the polish
      shape, under every register-mode launch geometry with 1-8 pairs per
      block, and memory mode.
3. Main path: simulates a 20,000-read pool (50 species, 700 bp, 7% error)
   with the port's simulator and runs the CLI in-process with
   --consensus --medaka, on the default backend (cuda) and on the native
   C++ engine.  Every output file must be byte-equal; each kernel's pair
   count must equal the pairs its callers asked for; both kernels must
   have launched in the cuda run and neither in the native run; the cuda
   run's pairs per launch are printed as a histogram.  A second
   run (5,000 reads, 20 species, --consensus --racon --racon_iter 2)
   covers the racon files, PAFs included, the same way.  A third (c) runs
   the 20k pool with --medaka_model and the in-repo GRU weights: besides
   the above, one GRU forward per polished center, on cuda:0 in the cuda
   run and on the CPU in the native run; it prints the GRU's device time
   and one center's logits difference between the card and the CPU.
4. GRU training (models/train.py) at full width (hidden 128, batch 16,
   window 256): one step's examples from seed 0 made with the moves kernel
   (band 150 pileups and band-0 draft labels) and with its plain version
   on the CPU must be bit-equal; one train step from the in-repo weights on
   cuda:0 against the CPU (loss, every gradient, and Adam alone on the
   same gradients); three steps of train() with the counts at 0, which
   must launch the moves kernel and write an npz that reloads with equal
   logits; and the seconds per step of example making and of the train
   step, beside the card's name and power limit.  The moves kernel's
   launches and pairs in train() stand in the JSON line as
   train_launches and train_pairs.
5. Distributed clustering (parallel/dist.py, NGSID_DISTRIBUTED=1):
   a. the 20k pool with --ont --abundance_ratio 0.005 (stages 1-3) through
      the CLI as 2 rank processes on the card, started as torchrun starts
      them (parallel/dist.spawn_local; this script re-run with
      --dist-rank), a gloo group between them and one outfolder each; and
      in this process at --t 2 (the merge tree) on cuda and on native.
      sorted.fastq, final_clusters.tsv and final_cluster_origins.tsv of
      both ranks must be byte-equal to each other and to both --t 2 runs;
      both ranks must have launched the stats kernel (counts at 0 before
      each rank's CLI run).  Prints each rank's launches, pairs, cluster
      wall and all-gathers (count and payload bytes), beside the --t 2
      runs' cluster walls.  Each rank's launches stand in the JSON line as
      the stats kernel's dist_launches.
   b. graft_entry.dryrun_multichip(8): one data 2 x model 4 train step of
      the GRU at hidden 128 over 8 gloo rank threads on the CPU, held
      against the single-device step (loss, gradients, Adam on the same
      gradients); the distributed clustering over 8 rank threads on the
      default backend (cuda: every rank launches the stats kernel, counted
      from 0, which stands in the JSON line as dryrun_launches) and over 2
      processes, each equal to the merge tree.  Prints the loss, the
      largest gradient gap and the walls.

Phase 5a spawns this script with ``--dist-rank OUT_JSON -- CLI ARGS``: it
then runs the CLI once as a rank of the launcher's world, counts from 0,
and writes its kernel counts, stage walls and all-gather traffic to
OUT_JSON.

The last three lines of standard output are the card's name and power
limit, the kernels' JSON line and {"ok": true, "device": {...}}.  Imports
nothing of JAX and nothing of the JAX package.
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STAGE3_OUTPUTS = ("sorted.fastq", "final_clusters.tsv",
                  "final_cluster_origins.tsv")
#: (pairs, min length, max length, k, band) of the stats kernel's cases;
#: the last is the clustering path's launch shape.
STATS_CASES = [(8, lo, hi, k, band)
               for lo, hi in ((90, 120), (300, 500), (500, 800), (1100, 1400))
               for k in (13, 20, 26) for band in (0, 150)] + [
                   (2, 2500, 3000, 13, 0), (1, 16400, 16800, 13, 150),
                   (1, 16400, 16800, 13, 0), (4096, 650, 750, 13, 150)]
#: (pairs, min length, max length, band, POA scoring) of the moves kernel's
#: cases; half of each batch mutated copies, half unrelated pairs.
MOVES_CASES = [(8, lo, hi, band, poa)
               for lo, hi in ((90, 120), (300, 500), (500, 800), (1100, 1400))
               for band in (0, 150) for poa in (True, False)] + [
                   (2, 2500, 3000, 0, True)]
#: The timed launches, (pairs, read length, band): the stats kernel's
#: clustering wave and a launch of the main path's typical size; the moves
#: kernel's polish and draft shapes; and for both, band 0 (the full DP, a
#: user setting) on ~700 bp and ~1.4 kb reads, whose windows (1152 and 1664
#: lanes) are wider than the stats kernel's register mode takes.  A moves
#: shape may add the range of its read lengths (default center +- 50 bp):
#: reads of 520-880 bp against a 700 bp center widen the polish band's
#: window to 384 lanes, 3 warps a pair, which share a block two or four at
#: a time once a launch has more pairs than the card has SMs
#: (cuda_lib.launch_geometry).
STATS_TIMED = ((4096, 700, 150), (128, 700, 150), (128, 700, 0),
               (128, 1400, 0))
MOVES_TIMED = ((512, 700, 150), (100, 700, 150), (100, 700, 0),
               (100, 1400, 0), (256, 700, 150, (520, 880)),
               (512, 700, 150, (520, 880)))
#: H100 SXM peaks (NVIDIA's H100 data sheet and architecture white paper):
#: device memory bytes per second and int32 operations per second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
#: int32 operations the DP must do per in-band cell.  Moves: the Gotoh
#: recurrence (E: 2 sub + max; F: 2 sub + max; diagonal: compare + add;
#: H: 2 max) and the move byte (2 compares for the layer, 2 for the
#: gap-open bits).  Stats: the same 9 score operations plus one push of the
#: path fields per layer (hist shift-in; popcount; 2 compares and an and
#: for the window; wcount add) x 3 layers, and one add for the diagonal
#: step's match and column counts (a gap step's column count follows from
#: the diagonal, csrc/stats_kernel.cu).
MOVES_OPS_PER_CELL = 13
STATS_OPS_PER_CELL = 9 + 3 * 6 + 1
#: (pairs, min length, max length, POA scoring) of the full-DP kernel's
#: cases: half of each batch mutated copies, half unrelated pairs, an
#: 11-pair batch, and one pair of ~8.5 kb reads (W 8704: memory mode, and
#: an s1 longer than 8,191 bytes, which the first full-DP kernel refused).
FULL_CASES = [(8, lo, hi, poa)
              for lo, hi in ((8, 90), (90, 120), (300, 500), (500, 800),
                             (1100, 1400))
              for poa in (True, False)] + [(11, 30, 40, False),
                                           (1, 8300, 8600, False)]
#: the full DP's operations per cell: the moves kernel's recurrence and
#: move byte
FULL_OPS_PER_CELL = MOVES_OPS_PER_CELL
#: The GRU's largest logits difference, cuda:0 against the CPU, on one
#: center's features.  float32 on both sides reads about 2e-5 on an H100;
#: TF32 would move it to about 1e-3.
GRU_LOGITS_ATOL = 1e-4
#: Phase 4's shapes: the reference trainer's defaults (models/train.py),
#: three steps of train(), and the train step's timed repeats.
TRAIN_BATCH = 16
TRAIN_WINDOW = 256
TRAIN_STEPS = 3
TRAIN_TIMED = 10
#: One train step, cuda:0 against the CPU: the tolerances that
#: tests/test_torch_train.py holds the port's step to against JAX's.
TRAIN_LOSS_ATOL = 1e-6
TRAIN_GRAD_RTOL = 1e-4
TRAIN_GRAD_ATOL = 1e-7
TRAIN_ADAM_ATOL = 1e-6
#: Phase 5a: the CLI's arguments (stages 1-3 of the 20k pool), the rank
#: processes and the seconds they may take together.
DIST_ARGS = ("--ont", "--abundance_ratio", "0.005")
DIST_RANKS = 2
DIST_TIMEOUT_S = 600


def log(msg):
    print(msg, flush=True)


def mutate(rng, s, rate):
    """ONT-like indel/substitution copy of a uint8 sequence."""
    import numpy as np

    r = rng.random(s.size)
    keep = r >= rate / 3
    out = s[keep].copy()
    sub = rng.random(out.size) < rate / 3
    out[sub] = rng.integers(65, 69, size=int(sub.sum()))
    ins = np.flatnonzero(rng.random(out.size) < rate / 3)
    return np.insert(out, ins, rng.integers(65, 69, size=ins.size)
                     ).astype(np.uint8)


def make_pairs(rng, B, lo, hi, k, related=0.5):
    """B seeded pairs with lengths in [lo, hi]: mutated copies (paths near
    the diagonal) and unrelated pairs (paths that leave the band)."""
    import numpy as np

    seqs, opens, mids = [], [], []
    for p in range(B):
        a = rng.integers(65, 69, size=int(rng.integers(lo, hi + 1))
                         ).astype(np.uint8)
        if p < B * related:
            b = mutate(rng, a, 0.1)
            b = b[: hi] if b.size > hi else b
            if b.size < lo:
                b = np.concatenate([b, rng.integers(65, 69, size=lo - b.size)
                                    ]).astype(np.uint8)
        else:
            b = rng.integers(65, 69, size=int(rng.integers(lo, hi + 1))
                             ).astype(np.uint8)
        seqs += [a, b]
        ers = 0.05 + 0.1 * rng.random()
        opens.append(int(rng.choice([2, 3, 4, 5])))
        mids.append(math.floor((1.0 - ers) * k))
    return seqs, opens, [k] * B, mids


def time_cuda(fn, runs):
    """Median milliseconds of fn() over `runs` warm runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def band_cells(A, pm, d_max, band):
    """In-band interior cells of a chunk's pairs, the DP's own cell set."""
    import torch

    _, i_lo, i_hi, _, _ = A.interior_rows(pm.cpu(), d_max, band)
    return int(torch.clamp(i_hi - i_lo + 1, min=0).sum())


def bound_ms(nbytes, ops):
    """The least time for the work: the larger of bytes over the memory
    rate and int32 operations over the int32 rate; and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def held_geometries(kind, cuda_call, plain_out, W, B, what):
    """For a small chunk: the kernel under every launch geometry it takes
    at W (each lane count, memory mode) equals the plain version's
    output."""
    import torch

    from ngspeciesid_tpu_torch.ops import cuda_lib

    if B > 8:
        return
    for geo in cuda_lib.geometries(kind, W):
        got = cuda_call(geo)
        got = got if isinstance(got, tuple) else (got,)
        want = plain_out if isinstance(plain_out, tuple) else (plain_out,)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{kind} kernel under {geo} differs from "
                                 f"the plain version: {what}")


def phase_stats_kernel(A, dev, cases=STATS_CASES):
    """Phase 2a: stats kernel rows against the plain version's, bit for bit,
    under the default launch geometry and, for small chunks, under every
    geometry the kernel takes."""
    import numpy as np
    import torch

    from ngspeciesid_tpu_torch.ops.align import (
        block_aligned_stats, identity_from_moves, match_vector, sg_align_batch)

    rng = np.random.default_rng(0)
    max_err = 0
    for B, lo, hi, k, band in cases:
        seqs, opens, ks, mids = make_pairs(rng, B, lo, hi, k)
        pool = A.SeqPool(dev)
        pool.ensure(seqs)
        r1, r2 = list(range(0, 2 * B, 2)), list(range(1, 2 * B, 2))
        chunks = A._plan_chunks(seqs, r1, r2)
        for sl in chunks:
            c1, c2 = [r1[i] for i in sl], [r2[i] for i in sl]
            co = [opens[i] for i in sl]
            cm = [mids[i] for i in sl]
            pm, base, W, d_max, len1, len2 = A.stage_chunk(
                pool, seqs, c1, c2, co, [k] * len(sl), cm, band)
            got = A.stats_rows(pool.buf, pm, base, W, d_max, band)
            want = A.stats_rows_plain(pool.buf, pm, base, W, d_max, band)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            what = f"B={B} len {lo}-{hi} k={k} band={band} W={W}"
            if not torch.equal(got, want):
                bad = (got != want).any(1).nonzero().flatten().tolist()
                raise AssertionError(
                    f"stats kernel rows differ from the plain version: "
                    f"{what} pairs {bad[:8]}")
            held_geometries(
                "stats", lambda geo: A._stats_rows_cuda(
                    pool.buf, pm, base, W, d_max, band, 2, -2, 1, geo=geo),
                want, W, len(sl), what)
            # (the oracle's full DP up to 3 kb: at 16.5 kb the plain
            # version is the spec)
            if band == 0 and B <= 8 and hi <= 3000:
                res = A._gather_chunk(
                    got.cpu().numpy(), len1, len2,
                    np.full(len(sl), k, np.int64), np.asarray(cm, np.int64),
                    band)
                pairs = [(seqs[a], seqs[b]) for a, b in zip(c1, c2)]
                moves = sg_align_batch(pairs, co, backend="numpy")
                for t, ((a, b), mv) in enumerate(zip(pairs, moves)):
                    vec = match_vector(mv, a, b)
                    want3 = block_aligned_stats(vec, k, cm[t], a.size,
                                                b.size) + (
                        identity_from_moves(mv, a, b),)
                    if tuple(res[t]) != tuple(want3):
                        raise AssertionError(
                            f"stats kernel statistics differ from the numpy "
                            f"oracle (len {lo}-{hi} k={k}): {res[t]} != "
                            f"{want3}")
        log(f"stats kernel == plain: B={B} len {lo}-{hi} k={k} band={band} "
            f"W={W} ({len(chunks)} chunk{'s' * (len(chunks) > 1)}"
            f"{', every geometry' if B <= 8 else ''})")
    return max_err


def phase_moves_kernel(A, M, dev, cases=MOVES_CASES):
    """Phase 2b: moves kernel rows and op streams against the plain
    version's, bit for bit, under the default launch geometry and, for
    small chunks, under every geometry the kernel takes."""
    import numpy as np
    import torch

    from ngspeciesid_tpu_torch.ops.align import sg_align_batch
    from ngspeciesid_tpu_torch.ops.poa import (
        POA_EXT, POA_MATCH, POA_MISMATCH, POA_OPEN)

    rng = np.random.default_rng(1)
    max_err = 0
    for B, lo, hi, band, poa in cases:
        seqs, opens, _, _ = make_pairs(rng, B, lo, hi, 13)
        scoring = (POA_MATCH, POA_MISMATCH, POA_EXT) if poa else (2, -2, 1)
        if poa:
            opens = [POA_OPEN] * B
        r1, r2 = list(range(0, 2 * B, 2)), list(range(1, 2 * B, 2))
        chunks = M._plan(seqs, r1, r2)
        for sl in chunks:
            c1, c2 = [r1[i] for i in sl], [r2[i] for i in sl]
            co = [opens[i] for i in sl]
            args, len1, len2 = moves_chunk(A, dev, seqs, c1, c2, co, band,
                                           scoring)
            best, ops = M.moves_rows(*args)
            p_best, p_ops = M.moves_rows_plain(*args)
            torch.cuda.synchronize()
            err = max(int((best.long() - p_best.long()).abs().max()),
                      int((ops.long() - p_ops.long()).abs().max()))
            max_err = max(max_err, err)
            what = f"B={B} len {lo}-{hi} band={band} poa={poa} W={args[3]}"
            if not (torch.equal(best, p_best) and torch.equal(ops, p_ops)):
                bad = ((best != p_best).any(1) | (ops != p_ops).any(1)
                       ).nonzero().flatten().tolist()
                raise AssertionError(
                    f"moves kernel differs from the plain version: {what} "
                    f"pairs {bad[:8]}")
            held_geometries(
                "moves", lambda geo: M._moves_rows_cuda(*args, geo=geo),
                (p_best, p_ops), args[3], len(sl), what)
            if band == 0:
                got = M._reconstruct(best.cpu().numpy(), ops.cpu().numpy(),
                                     len1, len2)
                pairs = [(seqs[a], seqs[b]) for a, b in zip(c1, c2)]
                want = sg_align_batch(pairs, co, *scoring, backend="numpy")
                for t, (g, w) in enumerate(zip(got, want)):
                    if g.tolist() != w.tolist():
                        raise AssertionError(
                            f"moves kernel differs from the numpy oracle: "
                            f"len {lo}-{hi} poa={poa} pair {t}")
        log(f"moves kernel == plain: {what} "
            f"({len(chunks)} chunk{'s' * (len(chunks) > 1)}"
            f"{', every geometry' if B <= 8 else ''})")
    return max_err


def moves_chunk(A, dev, seqs, r1, r2, opens, band, scoring):
    """A moves chunk's kernel arguments on ``dev``, and its lengths."""
    pool = A.SeqPool(dev)
    pool.ensure(seqs)
    B = len(r1)
    pm, base, W, d_max, len1, len2 = A.stage_chunk(
        pool, seqs, r1, r2, opens, [0] * B, [0] * B, band)
    return (pool.buf, pm, base, W, d_max, band, *scoring), len1, len2


def stats_shape(A, dev, rng, B, length=700, band=150):
    """B clustering-shaped pairs (length +- 50 bp, k 13) in one chunk: the
    stats kernel's arguments on ``dev``, and the lengths."""
    seqs, opens, ks, mids = make_pairs(rng, B, length - 50, length + 50, 13)
    pool = A.SeqPool(dev)
    pool.ensure(seqs)
    r1, r2 = list(range(0, 2 * B, 2)), list(range(1, 2 * B, 2))
    assert len(A._plan_chunks(seqs, r1, r2)) == 1
    pm, base, W, d_max, len1, len2 = A.stage_chunk(
        pool, seqs, r1, r2, opens, ks, mids, band)
    return (pool.buf, pm, base, W, d_max, band), len1, len2


def moves_shape(A, M, dev, rng, B, length=700, band=150, reads=None):
    """One center of ``length`` bp against B reads mutated from it, of
    length +- 50 bp or in ``reads`` = (lo, hi) (POA scoring; band 150 is
    the polish band) in one chunk: the moves kernel's arguments on
    ``dev``, the center and the read lengths."""
    from ngspeciesid_tpu_torch.ops.poa import (
        POA_EXT, POA_MATCH, POA_MISMATCH, POA_OPEN)

    center, reads = polish_shape(rng, B, length, reads)
    seqs = [center] + reads
    r2 = list(range(1, len(seqs)))
    assert len(M._plan(seqs, [0] * B, r2)) == 1
    args, _, len2 = moves_chunk(
        A, dev, seqs, [0] * B, r2, [POA_OPEN] * B, band,
        (POA_MATCH, POA_MISMATCH, POA_EXT))
    return args, center, len2


def phase_kernel_times(A, M, dev, plain=True):
    """Phase 2d: each kernel's time per launch (CUDA events, warm median)
    at its timed shapes, with the moves kernel's forward sweep alone, the
    plain version's time, after checking them bit-equal there, and the
    bound; ``plain=False`` times the kernels alone (an older checkout's
    kernels, through the same public wrappers).  Returns {kind: [one dict
    per shape]}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    out = {"stats": [], "moves": []}
    shapes = [("stats", *s) for s in STATS_TIMED] + [("moves", *s)
                                                    for s in MOVES_TIMED]
    for kind, B, length, band, *reads in shapes:
        if kind == "stats":
            args, len1, len2 = stats_shape(A, dev, rng, B, length, band)
            kern, ref = A.stats_rows, A.stats_rows_plain
            W, d_max = args[3], args[4]
            # bytes: both sequences, the pair table and the window
            # schedule in, the endpoint rows out
            nbytes = (int((len1 + len2).sum()) + args[1].numel() * 8
                      + args[2].numel() * 4 + B * 16 * 4)
            cells = band_cells(A, args[1], d_max, band)
            ops = cells * STATS_OPS_PER_CELL
        else:
            args, center, len2 = moves_shape(A, M, dev, rng, B, length,
                                             band, *reads)
            kern, ref = M.moves_rows, M.moves_rows_plain
            W, d_max = args[3], args[4]
            cells = band_cells(A, args[1], d_max, args[5])
            # bytes: the center once and every read, the pair table and the
            # window schedule in; the endpoint rows and op streams out; and
            # the move store, one byte per in-band cell, counted once
            nbytes = (center.size + int(len2.sum()) + args[1].numel() * 8
                      + args[2].numel() * 4 + B * 16 * 4
                      + B * args[2].numel() + cells)
            ops = cells * MOVES_OPS_PER_CELL
        row = dict(pairs=B, length=length, reads=reads[0] if reads else None,
                   band=args[5], W=W,
                   diagonals=d_max, cells=cells, bytes=nbytes,
                   ms=time_cuda(lambda: kern(*args), 9))
        if plain and kind == "moves":
            # the forward sweep alone: the rest is the traceback's
            row["sweep_ms"] = time_cuda(
                lambda: M._moves_rows_cuda(*args, traceback=False), 9)
        if plain:
            got, want = kern(*args), ref(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{kind} kernel differs from the plain "
                                     f"version at the {B}-pair shape")
            bound, by = bound_ms(nbytes, ops)
            row.update(plain_ms=time_cuda(lambda: ref(*args), 3),
                       bound_ms=bound, bound_by=by)
        log(f"{kind} kernel at {B} pairs (~{length} bp, band {args[5]}, "
            f"W={W}, {d_max} diagonals, {cells} in-band cells, {nbytes} "
            f"bytes): {json.dumps(row)}")
        out[kind].append(row)
    return out


def phase_geometry_sweep(A, M, F, dev):
    """The kernels' time at each timed shape under every register-mode
    geometry with 1, 2, 4 or 8 pairs per block, and memory mode (CUDA
    events, warm median): the measurements behind
    cuda_lib.launch_geometry's rule, which the full DP takes from the moves
    kernel ("full" below, at the polish shape, unbanded)."""
    import numpy as np

    from ngspeciesid_tpu_torch.ops import cuda_lib
    from ngspeciesid_tpu_torch.ops.poa import POA_EXT, POA_MATCH, POA_MISMATCH

    rng = np.random.default_rng(5)
    shapes = ([("stats", *x) for x in STATS_TIMED]
              + [("moves", *x) for x in MOVES_TIMED] + [("full", 512, 700, 0)])
    for kind, B, length, band, *reads in shapes:
        if kind == "stats":
            args = stats_shape(A, dev, rng, B, length, band)[0]
            call = A._stats_rows_cuda
            extra = (2, -2, 1)
            W = args[3]
        elif kind == "moves":
            args = moves_shape(A, M, dev, rng, B, length, band, *reads)[0]
            call = M._moves_rows_cuda
            extra = ()
            W = args[3]
        else:
            _, pairs, opens = full_polish_case(rng)
            args = F.stage_pairs(pairs, opens, dev)[:4]
            call = F._full_dp_rows_cuda
            extra = (POA_MATCH, POA_MISMATCH, POA_EXT)
            W = args[2]
        geo_kind = "moves" if kind == "full" else kind
        auto = cuda_lib.launch_geometry(geo_kind, W, B,
                                        cuda_lib.sm_count(dev.index))
        times = {}
        for g in cuda_lib.geometries(geo_kind, W):
            for pairs in ((1,) if g.memory else (1, 2, 4, 8)):
                geo = g._replace(pairs=pairs)
                if not geo.memory and geo.threads > \
                        cuda_lib.block_threads(geo_kind, geo.lanes):
                    continue
                times[str(tuple(geo))] = time_cuda(
                    lambda: call(*args, *extra, geo=geo), 5)
        log(f"geometry sweep, {kind} at {B} pairs, ~{length} bp"
            f"{f' (reads {reads[0]})' if reads else ''}, band "
            f"{band}, W={W} (lanes, warps, pairs, memory): "
            f"{json.dumps(times)}; default {tuple(auto)}")


def polish_shape(rng, n=512, length=700, reads=None):
    """One center of ``length`` bp and n reads mutated from it, of length
    +- 50 bp; or, with ``reads`` = (lo, hi), each cut at its end or
    extended there with random bases to a length drawn from [lo, hi]."""
    import numpy as np

    center = rng.integers(65, 69, size=length).astype(np.uint8)
    lo, hi = reads or (length - 50, length + 50)
    out = []
    while len(out) < n:
        r = mutate(rng, center, 0.07)
        if reads:
            want = int(rng.integers(lo, hi + 1))
            r = np.concatenate([r[:want], rng.integers(
                65, 69, size=max(0, want - r.size)).astype(np.uint8)])
        if lo <= r.size <= hi:
            out.append(r)
    return center, out


def device_trace(fn):
    """Run fn() once under torch.profiler and read its device side from the
    trace: kernel, copy and memset milliseconds, and the bytes of each
    direction of copy ({"DtoH": bytes, ...})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    out = dict(kernel_ms=0.0, memcpy_ms=0.0, memset_ms=0.0, copied={},
               kernels=0)
    for ev in events:
        cat = ev.get("cat", "")
        ms = float(ev.get("dur", 0)) / 1e3
        if cat == "kernel":
            out["kernel_ms"] += ms
            out["kernels"] += 1
        elif cat == "gpu_memset":
            out["memset_ms"] += ms
        elif cat == "gpu_memcpy":
            out["memcpy_ms"] += ms
            kind = next((k for k in ("DtoH", "HtoD", "DtoD")
                         if k in ev.get("name", "")), "other")
            out["copied"][kind] = out["copied"].get(kind, 0) + int(
                ev.get("args", {}).get("bytes", 0))
    return out


def full_polish_case(rng):
    """The full DP's timed shape: one 700 bp center against 512 reads of
    650-750 bp (the moves kernel's polish shape, unbanded), POA scoring."""
    from ngspeciesid_tpu_torch.ops.poa import POA_OPEN

    center, reads = polish_shape(rng)
    return center, [(center, r) for r in reads], [POA_OPEN] * len(reads)


def time_full_entry(F, rng):
    """The full DP's entry point, sg_align_batch_full, at the polish shape
    on the default device: its wall (host clock, warm, median of 3) and
    one call's device side under torch.profiler.  Only the entry point's
    name and signature are used, so an older checkout is timed the same
    way."""
    import torch

    from ngspeciesid_tpu_torch.ops.poa import POA_EXT, POA_MATCH, POA_MISMATCH

    poa = (POA_MATCH, POA_MISMATCH, POA_EXT)
    _, pairs, opens = full_polish_case(rng)
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        F.sg_align_batch_full(pairs, opens, *poa)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    trace = device_trace(lambda: F.sg_align_batch_full(pairs, opens, *poa))
    row = dict(wall_s=statistics.median(walls[1:]), walls_s=walls, **trace)
    log(f"full DP entry point sg_align_batch_full at the polish shape: "
        f"{json.dumps(row)}")
    return row


def phase_full_dp_kernel(F, M, dev, cases=FULL_CASES):
    """Phase 2c: full-DP kernel endpoint rows and op streams against the
    plain version's, bit for bit, under the default launch geometry and,
    for small chunks, under every geometry; op streams against the numpy
    oracle (small sizes) and the native engine's band-0 DP (the ~8.5 kb
    pair and the polish shape); its time at the polish shape, the forward
    sweep alone, and the plain version's; the entry point's wall in parts;
    and its launches from the entry point, ``sg_align_batch_full``, run
    once at that shape with the counts at 0, copying only the endpoint rows
    and the op streams to the host."""
    import numpy as np
    import torch

    from ngspeciesid_tpu_torch import native
    from ngspeciesid_tpu_torch.ops.align import sg_align_batch
    from ngspeciesid_tpu_torch.ops.poa import (
        POA_EXT, POA_MATCH, POA_MISMATCH, POA_OPEN)

    rng = np.random.default_rng(2)
    poa = (POA_MATCH, POA_MISMATCH, POA_EXT)
    max_err = 0

    def held(pairs, opens, scoring, what):
        nonlocal max_err
        *args, len1, len2 = F.stage_pairs(pairs, opens, dev)
        best, ops = F.full_dp_rows(*args, *scoring)
        p_best, p_ops = F.full_dp_rows_plain(*args, *scoring)
        torch.cuda.synchronize()
        err = max(int((best.long() - p_best.long()).abs().max()),
                  int((ops.long() - p_ops.long()).abs().max()))
        max_err = max(max_err, err)
        if not (torch.equal(best, p_best) and torch.equal(ops, p_ops)):
            bad = (best != p_best).any(1) | (ops != p_ops).any(1)
            raise AssertionError(
                f"full DP kernel differs from the plain version: {what}, "
                f"pairs {bad.nonzero().flatten().tolist()[:8]}")
        held_geometries(
            "moves", lambda geo: F._full_dp_rows_cuda(*args, *scoring,
                                                     geo=geo),
            (p_best, p_ops), args[2], len(pairs), what)
        return args, best, ops, len1, len2

    def streams(best, ops, len1, len2):
        return M._reconstruct(best.cpu().numpy(), ops.cpu().numpy(), len1,
                              len2)

    for B, lo, hi, is_poa in cases:
        seqs, opens, _, _ = make_pairs(rng, B, lo, hi, 13)
        scoring = poa if is_poa else (2, -2, 1)
        if is_poa:
            opens = [POA_OPEN] * B
        pairs = list(zip(seqs[0::2], seqs[1::2]))
        what = (f"B={B} len {lo}-{hi} "
                f"{'POA' if is_poa else 'clustering'} scoring")
        args, best, ops, len1, len2 = held(pairs, opens, scoring, what)
        if hi <= 500:
            got = F.sg_align_batch_full(pairs, opens, *scoring, device=dev)
            want = sg_align_batch(pairs, opens, *scoring, backend="numpy")
            for t, (g, w) in enumerate(zip(got, want)):
                if g.tolist() != w.tolist():
                    raise AssertionError(
                        f"full DP op streams differ from the numpy oracle: "
                        f"{what}, pair {t}")
        elif hi > 8191:
            got = streams(best, ops, len1, len2)
            want = native.align_batch_native(pairs, opens, *scoring, band=0)
            if [g.tolist() for g in got] != [w.tolist() for w in want]:
                raise AssertionError(f"full DP op streams differ from the "
                                     f"native band-0 DP: {what}")
        geo = "every geometry" if B <= 8 else "default geometry"
        log(f"full DP kernel == plain: {what}, W={args[2]} ({geo}"
            f"{', streams == numpy oracle' if hi <= 500 else ''}"
            f"{', streams == native band-0 DP' if hi > 8191 else ''})")

    center, pairs, opens = full_polish_case(rng)
    args, best, ops, len1, len2 = held(pairs, opens, poa, "polish shape")
    ms = time_cuda(lambda: F.full_dp_rows(*args, *poa), 9)
    sweep_ms = time_cuda(
        lambda: F._full_dp_rows_cuda(*args, *poa, traceback=False), 9)
    plain_ms = time_cuda(lambda: F.full_dp_rows_plain(*args, *poa), 3)

    # the entry point's wall in its parts (host clock, each part ended by a
    # synchronize): staging (pool upload and pair table), the kernel, the
    # download of the endpoint rows and op streams, the host reconstruction
    parts = {}
    t0 = time.perf_counter()
    *args2, len1, len2 = F.stage_pairs(pairs, opens, dev)
    torch.cuda.synchronize()
    parts["staging_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    best2, ops2 = F.full_dp_rows(*args2, *poa)
    torch.cuda.synchronize()
    parts["kernel_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = best2.cpu().numpy(), ops2.cpu().numpy()
    parts["download_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    M._reconstruct(*host, len1, len2)
    parts["reconstruct_s"] = time.perf_counter() - t0

    F.reset_counts()
    t0 = time.perf_counter()
    got = F.sg_align_batch_full(pairs, opens, *poa)   # default device
    entry_s = time.perf_counter() - t0
    launches, launched_pairs = F.LAUNCHES, F.PAIRS
    if launches == 0 or launched_pairs != len(pairs) or F.PLAIN_LAUNCHES:
        raise AssertionError(
            f"sg_align_batch_full ran {launched_pairs} pairs in {launches} "
            f"kernel launches and {F.PLAIN_LAUNCHES} plain ones")
    want = native.align_batch_native(pairs, opens, *poa, band=0)
    for t, (g, w) in enumerate(zip(got, want)):
        if g.tolist() != w.tolist():
            raise AssertionError(f"full DP op streams differ from the native "
                                 f"band-0 DP at the polish shape: pair {t}")
    trace = device_trace(lambda: F.sg_align_batch_full(pairs, opens, *poa))
    host_bytes = best.numel() * 4 + ops.numel()
    if trace["copied"].get("DtoH") != host_bytes:
        raise AssertionError(
            f"sg_align_batch_full copied {trace['copied']} bytes between "
            f"host and device; only the endpoint rows and op streams, "
            f"{host_bytes} bytes, should come back")
    cells = int((args[1][:, 0] * args[1][:, 1]).sum())
    # bytes the work needs: the center once and every read, the pair
    # table, one move byte per cell, the endpoint rows and op streams out
    nbytes = (center.size + int(len2.sum()) + args[1].numel() * 8 + cells
              + host_bytes)
    bound, by = bound_ms(nbytes, cells * FULL_OPS_PER_CELL)
    row = dict(ms=ms, sweep_ms=sweep_ms, traceback_ms=ms - sweep_ms,
               plain_ms=plain_ms, bound_ms=bound,
               bound_by=by, W=args[2], diagonals=args[3], cells=cells,
               bytes=nbytes, entry_wall_s=entry_s, entry_parts=parts,
               entry_device=trace)
    log(f"full DP kernel at the polish shape (512 pairs, 700 bp center, "
        f"reads 650-750 bp, W={args[2]}, {args[3]} diagonals, {cells} "
        f"cells, {nbytes} bytes needed): {json.dumps(row)}")
    log(f"full DP entry point sg_align_batch_full at the polish shape: "
        f"{launches} launch(es), {launched_pairs} pairs, wall {entry_s} s, op "
        f"streams == native band-0 DP, {trace['copied'].get('DtoH')} bytes "
        f"to the host (endpoint rows and op streams only)")
    return launches, dict(max_abs_err=max_err, **row)


def warm_native():
    """Build the port's C++ engine (g++, at first use) before the timed
    runs, so that neither main-path run pays for it."""
    import numpy as np

    from ngspeciesid_tpu_torch.ops.align import block_stats_batch

    a = np.frombuffer(b"ACGTACGTTGCA" * 8, np.uint8)
    block_stats_batch([(a, a)], [3], [13], [9], backend="native")


def _tree(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


def leaves_band(moves, n, m, band):
    """Whether an alignment's path leaves the DP band (cells (i, j) with
    (j - band) * n <= i * m <= (j + band + 1) * n - 1)."""
    i = j = 0
    for mv in moves.tolist():
        i += mv != 3
        j += mv != 2
        if mv == 1 and not ((j - band) * n <= i * m <= (j + band + 1) * n - 1):
            return True
    return False


def explain_stage4_diff(work, name):
    """Name the center of a differing stage-4 file and the first read whose
    polish alignment differs between cuda and native (round 1)."""
    import numpy as np

    from ngspeciesid_tpu_torch.consensus.stage import _polish_subset
    from ngspeciesid_tpu_torch.io.fastx import read_fastx
    from ngspeciesid_tpu_torch.ops import poa
    from ngspeciesid_tpu_torch.ops.align import sg_align_batch

    found = re.search(r"(?:cl_id_|_)(\d+)[./]", name)
    if not found:
        return f"{name} differs"
    c_id = found.group(1)
    ref = os.path.join(work, "native", f"consensus_reference_{c_id}.fasta")
    reads_fq = os.path.join(work, "native", f"reads_to_consensus_{c_id}.fastq")
    if name.startswith("consensus_reference_") or not os.path.isfile(ref):
        return f"center {c_id}: {name} differs (draft, trim or RC merge)"
    center = np.frombuffer(next(read_fastx(ref))[1].encode(), np.uint8)
    reads = [np.frombuffer(s.encode(), np.uint8)
             for _, s, _ in read_fastx(reads_fq)]
    reads = _polish_subset(reads, reads)[0]
    reads = poa.orient_reads(center, reads)[0]
    pairs = [(center, r) for r in reads]
    got = {b: sg_align_batch(pairs, [poa.POA_OPEN] * len(pairs),
                             poa.POA_MATCH, poa.POA_MISMATCH, poa.POA_EXT,
                             backend=b, band=poa.POA_BAND)
           for b in ("cuda", "native")}
    for t, (a, b) in enumerate(zip(got["cuda"], got["native"])):
        if a.tolist() != b.tolist():
            out = leaves_band(b, center.size, reads[t].size, poa.POA_BAND)
            return (f"center {c_id}: {name} differs; first differing pair: "
                    f"read {t} of {len(reads)} ({reads[t].size} bp) against "
                    f"the {center.size} bp center; native path "
                    f"{'leaves' if out else 'stays inside'} the band")
    return f"center {c_id}: {name} differs; no round-1 pair differs"


def run_backends(A, M, work, pool, args, gru=False):
    """The CLI on ``pool`` with ``args``, on cuda and on native: every
    output file byte-equal, kernel pairs equal to the pairs asked for, both
    kernels launched on cuda and neither on native; with ``gru``, one GRU
    forward per polished center, on cuda:0 in the cuda run and on the CPU
    in the native run.  Returns the cuda run's kernel launches."""
    from ngspeciesid_tpu_torch import cli
    from ngspeciesid_tpu_torch.cluster import engine
    from ngspeciesid_tpu_torch.models import polisher

    asked = {"stats": 0, "moves": 0}
    calls = {"stats": (A, "sg_stats_pool_torch"),
             "moves": (M, "sg_moves_pool_torch")}
    real = {k: getattr(mod, fn) for k, (mod, fn) in calls.items()}

    def counted(kind):
        def call(seqs, rows1, *a, **kw):
            asked[kind] += len(rows1)
            return real[kind](seqs, rows1, *a, **kw)
        return call

    results = {}
    for backend in ("cuda", "native"):
        out = os.path.join(work, backend)
        os.environ["NGSID_STATS_BACKEND"] = backend
        walls = {}
        for k, (mod, fn) in calls.items():
            setattr(mod, fn, counted(k))
        asked.update(stats=0, moves=0)
        A.reset_counts()
        M.reset_counts()
        polisher.FORWARDS.clear()
        engine.reset_perf_counters()
        t0 = time.perf_counter()
        try:
            rc = cli.main([*args, "--fastq", pool, "--outfolder", out],
                          stage_walls=walls)
            if backend == "cuda":
                import torch

                torch.cuda.synchronize()
        finally:
            for k, (mod, fn) in calls.items():
                setattr(mod, fn, real[k])
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"CLI with backend {backend} exited {rc}")
        counts = {"stats": (A.LAUNCHES, A.PAIRS), "moves": (M.LAUNCHES,
                                                           M.PAIRS)}
        if backend == "cuda":
            sizes = {"stats": list(A.SIZES), "moves": list(M.SIZES)}
        results[backend] = (counts, dict(asked), dict(polisher.FORWARDS))
        log(f"[{backend}] {' '.join(args)}: wall {wall} s, stage walls "
            f"{json.dumps(walls)}, kernel launches/pairs {json.dumps(counts)}"
            f", pairs asked {json.dumps(asked)}, GRU forwards "
            f"{json.dumps(polisher.FORWARDS)}, engine phases "
            f"{json.dumps(engine.PERF_COUNTERS)}")
    del os.environ["NGSID_STATS_BACKEND"]
    cuda, native = (_tree(os.path.join(work, b)) for b in ("cuda", "native"))
    if sorted(cuda) != sorted(native):
        raise AssertionError(f"output files differ: cuda {sorted(cuda)} vs "
                             f"native {sorted(native)}")
    for name in STAGE3_OUTPUTS:
        if not cuda.get(name):
            raise AssertionError(f"{name} missing or empty")
    polished = [n for n in cuda if n.endswith("consensus.fasta")]
    if not polished:
        raise AssertionError("no polished consensus was written")
    for name in sorted(cuda):
        if cuda[name] != native[name]:
            raise AssertionError(explain_stage4_diff(work, name))
    log(f"{len(cuda)} output files byte-equal between cuda and native "
        f"({len(polished)} polished centers, "
        f"{sum(len(v) for v in cuda.values())} bytes)")
    counts, asked_cuda, _ = results["cuda"]
    for kind in ("stats", "moves"):
        launches, pairs = counts[kind]
        if launches == 0 or pairs != asked_cuda[kind]:
            raise AssertionError(
                f"{kind} kernel ran {pairs} pairs in {launches} launches, "
                f"its callers asked for {asked_cuda[kind]}")
        if results["native"][0][kind] != (0, 0):
            raise AssertionError(f"the native run launched the {kind} kernel")
    for backend, device in (("cuda", "cuda:0"), ("native", "cpu")):
        want = {device: len(polished)} if gru else {}
        if results[backend][2] != want:
            raise AssertionError(
                f"GRU forwards of the {backend} run: {results[backend][2]}, "
                f"expected {want}")
    for kind in ("stats", "moves"):
        log(f"[cuda] {kind} kernel pairs per launch: "
            f"{json.dumps(histogram(sizes[kind]))}")
    return {kind: counts[kind][0] for kind in counts}, sizes


def histogram(sizes):
    """Launch sizes in power-of-two bins: {"lo-hi": launches}."""
    out = {}
    lo = 1
    while lo <= max(sizes, default=0):
        n = sum(lo <= s < 2 * lo for s in sizes)
        if n:
            out[f"{lo}-{2 * lo - 1}"] = n
        lo *= 2
    return out


def phase_gru(A, M, work, pool):
    """Phase 3c: the main path with the GRU polisher (--medaka_model, the
    in-repo weights) on cuda and on native, through run_backends; the GRU's
    device time (CUDA events around each cuda forward, feature upload and
    logits download included); and one center's logits on the card against
    the CPU's on the same features."""
    import numpy as np
    import torch

    from ngspeciesid_tpu_torch.models import polisher

    weights = os.path.join(HERE, "ngspeciesid_tpu_torch", "data",
                           "polisher_gru.npz")
    real = polisher.forward_logits
    first = []
    gru_ms = []

    def timed(model, feats):
        if next(model.parameters()).device.type != "cuda":
            return real(model, feats)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(model, feats)
        end.record()
        end.synchronize()
        gru_ms.append(start.elapsed_time(end))
        if not first:
            first.append((feats, out))
        return out

    polisher.forward_logits = timed
    try:
        launches = run_backends(
            A, M, work, pool,
            ["--ont", "--consensus", "--medaka", "--medaka_model", weights,
             "--abundance_ratio", "0.005"], gru=True)[0]
    finally:
        polisher.forward_logits = real
    feats, gpu = first[0]
    cpu = real(polisher.load_params(weights, torch.device("cpu")), feats)
    gap = float(np.abs(gpu - cpu).max())
    same_argmax = bool((gpu.argmax(-1) == cpu.argmax(-1)).all())
    log(f"GRU on cuda:0: {len(gru_ms)} forwards, {sum(gru_ms)} ms in all, "
        f"median {statistics.median(gru_ms)} ms (features {feats.shape}); "
        f"first center's logits, cuda:0 vs CPU: max abs difference {gap} "
        f"(limit {GRU_LOGITS_ATOL}), argmax equal {same_argmax}")
    if gap > GRU_LOGITS_ATOL or not same_argmax:
        raise AssertionError(
            f"GRU logits on cuda:0 differ from the CPU's by {gap} (limit "
            f"{GRU_LOGITS_ATOL}), argmax equal {same_argmax}: is the card's "
            f"GRU running below float32 (TF32)?")
    return launches


def phase_train(M, smi):
    """Phase 4: GRU training (models/train.py) on cuda:0 at full width
    (hidden 128, batch 16, window 256).  (a) one step's examples from seed
    0, made on the card and with the plain versions on the CPU, must be
    bit-equal; (b) one step from the in-repo weights on that batch, on
    cuda:0 and on the CPU: the loss and every gradient within
    TRAIN_LOSS_ATOL and TRAIN_GRAD_RTOL/ATOL, and Adam alone (the CPU's
    gradients into both optimizers) within TRAIN_ADAM_ATOL; (c) the main
    path, three steps of train() with the counts at 0: the moves kernel
    launched, the written npz reloads with logits equal to the in-memory
    model's; (d) seconds per step of example making (host wall) and of the
    train step (CUDA events), beside the card.  Returns the moves kernel's
    launches and pairs in (c)."""
    import numpy as np
    import torch

    from ngspeciesid_tpu_torch.models import polisher, train

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    weights = os.path.join(HERE, "ngspeciesid_tpu_torch", "data",
                           "polisher_gru.npz")
    batches, walls, counts = {}, {}, {}
    for backend in ("cuda", "torch"):
        os.environ["NGSID_STATS_BACKEND"] = backend
        M.reset_counts()
        t0 = time.perf_counter()
        batches[backend] = train.make_batch(np.random.default_rng(0),
                                            TRAIN_BATCH, TRAIN_WINDOW)
        walls[backend] = time.perf_counter() - t0
        counts[backend] = (M.LAUNCHES, M.PAIRS, M.PLAIN_PAIRS)
    for name, got, want in zip(("feats", "labels", "mask"), batches["cuda"],
                               batches["torch"]):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"training examples: {name} made on the "
                                 f"card differs from the plain versions'")
    launches, pairs, _ = counts["cuda"]
    if launches < 2 * TRAIN_BATCH or counts["torch"][:2] != (0, 0):
        raise AssertionError(f"training examples: moves launches/pairs "
                             f"{counts}")
    log(f"[train a] {TRAIN_BATCH} examples (window {TRAIN_WINDOW}) bit-equal"
        f" between the moves kernel ({launches} launches, {pairs} pairs, "
        f"{walls['cuda']} s) and its plain version on the CPU "
        f"({counts['torch'][2]} pairs, {walls['torch']} s)")

    def step_on(device, batch):
        model = polisher.load_params(weights, device)
        step = polisher.make_train_step(model)
        loss = step(*(torch.from_numpy(a).to(device) for a in batch))
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.grad is not None}
        return float(loss), grads, step

    batch = batches["cuda"]
    loss_g, grads_g, step_g = step_on(dev, batch)
    loss_c, grads_c, _ = step_on(cpu, batch)
    gaps = {n: float((grads_g[n] - grads_c[n]).abs().max()) for n in grads_c}
    bad = [n for n in grads_c if not torch.allclose(
        grads_g[n], grads_c[n], rtol=TRAIN_GRAD_RTOL, atol=TRAIN_GRAD_ATOL)]
    if sorted(grads_g) != sorted(grads_c) or bad or \
            abs(loss_g - loss_c) > TRAIN_LOSS_ATOL:
        raise AssertionError(f"train step on cuda:0 vs CPU: loss {loss_g} vs "
                             f"{loss_c}, gradients out of tolerance {bad}, "
                             f"max abs gaps {gaps}")
    adam = {}
    for device in (dev, cpu):
        model = polisher.load_params(weights, device)
        step = polisher.make_train_step(model)
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = grads_c[n].to(device)
        step.optimizer.step()
        adam[device.type] = polisher.params_to_jax(model.state_dict())
    adam_gap = max(float(np.abs(adam["cuda"][k] - adam["cpu"][k]).max())
                   for k in adam["cpu"])
    if adam_gap > TRAIN_ADAM_ATOL:
        raise AssertionError(f"Adam on cuda:0 vs CPU, same gradients: max "
                             f"abs weight gap {adam_gap}")
    log(f"[train b] one step from the in-repo weights, cuda:0 vs CPU: loss "
        f"{loss_g} vs {loss_c}; largest gradient gap {max(gaps.values())} "
        f"(rtol {TRAIN_GRAD_RTOL}, atol {TRAIN_GRAD_ATOL}); Adam on the same"
        f" gradients: largest weight gap {adam_gap} (atol {TRAIN_ADAM_ATOL})")

    os.environ["NGSID_STATS_BACKEND"] = "cuda"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        out = os.path.join(tmp, "gru.npz")
        M.reset_counts()
        polisher.FORWARDS.clear()
        t0 = time.perf_counter()
        model = train.train(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                            window=TRAIN_WINDOW, seed=0, out=out, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        main_path = (M.LAUNCHES, M.PAIRS)
        if M.LAUNCHES == 0 or M.PLAIN_PAIRS:
            raise AssertionError(f"train(): moves kernel launches {M.LAUNCHES}"
                                 f", plain pairs {M.PLAIN_PAIRS}")
        if next(model.parameters()).device != dev:
            raise AssertionError("train() did not train on cuda:0")
        feats = np.random.default_rng(1).random(
            (2, TRAIN_WINDOW, polisher.N_FEATURES), dtype=np.float32)
        got = polisher.forward_logits(polisher.load_params(out, dev), feats)
        want = polisher.forward_logits(model.eval(), feats)
        if not np.array_equal(got, want) or not np.isfinite(got).all():
            raise AssertionError("the written npz's logits differ from the "
                                 "trained model's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del os.environ["NGSID_STATS_BACKEND"]
    log(f"[train c] train(): {TRAIN_STEPS} steps in {wall} s, moves kernel "
        f"{main_path[0]} launches / {main_path[1]} pairs; the npz reloads "
        f"with equal logits")

    feats, labels, mask = (torch.from_numpy(a).to(dev) for a in batch)
    step_ms = time_cuda(lambda: step_g(feats, labels, mask), TRAIN_TIMED)
    log(f"[train d] per step (batch {TRAIN_BATCH}, window {TRAIN_WINDOW}, "
        f"hidden {polisher.HIDDEN}): example making {walls['cuda']} s host "
        f"wall, train step {step_ms} ms (CUDA events, median of "
        f"{TRAIN_TIMED}); card {smi}")
    return main_path


def dist_rank(out_json, cli_args):
    """Phase 5a's rank process: the CLI once with the stats counts at 0;
    its counts, walls and all-gather traffic to ``out_json``."""
    import torch

    from ngspeciesid_tpu_torch import cli
    from ngspeciesid_tpu_torch.ops import align_stats as A
    from ngspeciesid_tpu_torch.parallel import dist

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    walls = {}
    A.reset_counts()
    dist.reset_counts()
    rc = cli.main(cli_args, stage_walls=walls)
    torch.cuda.synchronize()
    with open(out_json, "w") as f:
        json.dump(dict(rc=rc, launches=A.LAUNCHES, pairs=A.PAIRS,
                       plain_pairs=A.PLAIN_PAIRS, sizes=histogram(A.SIZES),
                       walls=walls, traffic=dict(dist.TRAFFIC)), f)
    return rc


def phase_distributed(A, work, pool, smi):
    """Phase 5a: the 20k pool's stages 1-3 as DIST_RANKS rank processes
    with NGSID_DISTRIBUTED=1 on the card, against --t 2 in this process on
    cuda and on native: every stage-3 file byte-equal, the stats kernel
    launched by every rank.  Returns each rank's stats launches."""
    from ngspeciesid_tpu_torch import cli
    from ngspeciesid_tpu_torch.parallel.dist import spawn_local

    files, cluster_walls = {}, {}
    for backend in ("cuda", "native"):
        out = os.path.join(work, f"t2_{backend}")
        os.environ["NGSID_STATS_BACKEND"] = backend
        walls = {}
        A.reset_counts()
        try:
            rc = cli.main([*DIST_ARGS, "--t", "2", "--fastq", pool,
                           "--outfolder", out], stage_walls=walls)
        finally:
            del os.environ["NGSID_STATS_BACKEND"]
        if rc != 0:
            raise AssertionError(f"--t 2 on {backend} exited {rc}")
        cluster_walls[f"--t 2 {backend}"] = walls["cluster"]
        log(f"[dist a] --t 2 on {backend}: stage walls {json.dumps(walls)}, "
            f"stats launches/pairs {A.LAUNCHES}/{A.PAIRS}")
        files[f"--t 2 {backend}"] = out
    env = dict(os.environ, NGSID_DISTRIBUTED="1")
    outs = [os.path.join(work, f"rank{r}") for r in range(DIST_RANKS)]
    stats = [os.path.join(work, f"rank{r}.json") for r in range(DIST_RANKS)]
    t0 = time.perf_counter()
    spawn_local([[sys.executable, os.path.join(HERE, "chip_smoke.py"),
                  "--dist-rank", st, "--", *DIST_ARGS, "--fastq", pool,
                  "--outfolder", out] for st, out in zip(stats, outs)],
                timeout_s=DIST_TIMEOUT_S, env=env, cwd=work)
    wall = time.perf_counter() - t0
    launches = []
    for r, (st, out) in enumerate(zip(stats, outs)):
        with open(st) as f:
            rank = json.load(f)
        if rank["rc"] != 0 or rank["launches"] == 0 or rank["plain_pairs"]:
            raise AssertionError(f"rank {r}: {json.dumps(rank)}")
        launches.append(rank["launches"])
        cluster_walls[f"rank {r}"] = rank["walls"]["cluster"]
        files[f"rank {r}"] = out
        log(f"[dist a] rank {r} of {DIST_RANKS}: stats kernel "
            f"{rank['launches']} launches / {rank['pairs']} pairs (pairs per "
            f"launch {json.dumps(rank['sizes'])}), stage walls "
            f"{json.dumps(rank['walls'])}, all-gathers "
            f"{json.dumps(rank['traffic'])}")
    for name in STAGE3_OUTPUTS:
        blobs = {}
        for who, folder in files.items():
            with open(os.path.join(folder, name), "rb") as f:
                blobs[who] = f.read()
        if not blobs["--t 2 native"] or len(set(blobs.values())) != 1:
            raise AssertionError(
                f"{name} differs: " + ", ".join(
                    f"{who} {len(b)} bytes" for who, b in blobs.items()))
    log(f"[dist a] {DIST_RANKS} rank processes, NGSID_DISTRIBUTED=1: "
        f"{' '.join(STAGE3_OUTPUTS)} byte-equal across both ranks and --t 2 "
        f"on cuda and native; {DIST_RANKS}-rank wall {wall} s (process start "
        f"to exit); cluster walls {json.dumps(cluster_walls)}; card {smi}")
    return launches


def phase_dryrun(A, smi):
    """Phase 5b: graft_entry.dryrun_multichip(8) with the clustering on the
    default backend (cuda), the stats counts at 0 before it; returns the
    stats kernel's launches in its distributed clustering."""
    from ngspeciesid_tpu_torch import graft_entry

    A.reset_counts()
    t0 = time.perf_counter()
    report = graft_entry.dryrun_multichip(8)
    wall = time.perf_counter() - t0
    train, clustering = report["train"], report["clustering"]
    train.pop("grads")
    if clustering["stats_launches"] == 0 or clustering["stats_plain_pairs"]:
        raise AssertionError(f"dry run clustering: {json.dumps(clustering)}")
    log(f"[dryrun b] dryrun_multichip(8): train step {json.dumps(train)}; "
        f"clustering over 8 rank threads {json.dumps(clustering)}; over "
        f"processes {json.dumps(report['processes'])}; wall {wall} s; "
        f"card {smi}")
    return clustering["stats_launches"]


def simulate(out, n_reads, n_species):
    subprocess.run(
        [sys.executable, "-m", "ngspeciesid_tpu_torch.simulate", "--out", out,
         "--n_reads", str(n_reads), "--n_species", str(n_species),
         "--length", "700", "--error", "0.07", "--seed", "0"],
        check=True, cwd=HERE, stdout=subprocess.DEVNULL)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--times-only", action="store_true",
                    help="build, then time the stats and moves kernels at "
                         "their shapes (phase 2d without the plain "
                         "versions) and the full DP's entry point at the "
                         "polish shape, and stop: run from another "
                         "checkout's root to time its kernels")
    ap.add_argument("--dist-rank", metavar="OUT_JSON",
                    help="run the CLI (the arguments after --) once as a "
                         "rank of phase 5a and write its counts to OUT_JSON")
    ap.add_argument("cli_args", nargs="*", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.cli_args and not opts.dist_rank:
        ap.error(f"unexpected arguments {opts.cli_args}")
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "ngspeciesid_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(ngspeciesid_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if opts.dist_rank:
        return dist_rank(opts.dist_rank, opts.cli_args)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from ngspeciesid_tpu_torch.ops import align_moves as M
    from ngspeciesid_tpu_torch.ops import align_stats as A
    from ngspeciesid_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    cuda_lib.load()
    log(f"kernel build and load: {time.perf_counter() - t0} s "
        f"(nvcc {cuda_lib.BUILD_SECONDS} s)")
    log(cuda_lib.BUILD_LOG.strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"card: {smi.splitlines()[0]}")
    from ngspeciesid_tpu_torch.ops import align_full as F

    if opts.times_only:
        phase_kernel_times(A, M, dev, plain=False)
        import numpy as np

        time_full_entry(F, np.random.default_rng(2))
        return 0

    t0 = time.perf_counter()
    warm_native()
    log(f"native engine build and load: {time.perf_counter() - t0} s")
    stats_err = phase_stats_kernel(A, dev)
    moves_err = phase_moves_kernel(A, M, dev)
    full_launches, full = phase_full_dp_kernel(F, M, dev)
    times = phase_kernel_times(A, M, dev)
    phase_geometry_sweep(A, M, F, dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pool20k = os.path.join(work, "pool20k.fastq")
        simulate(pool20k, 20000, 50)
        launches, sizes = run_backends(
            A, M, os.path.join(work, "medaka"), pool20k,
            ["--ont", "--consensus", "--medaka", "--abundance_ratio", "0.005"])
        pool = os.path.join(work, "pool5k.fastq")
        simulate(pool, 5000, 20)
        run_backends(
            A, M, os.path.join(work, "racon"), pool,
            ["--ont", "--consensus", "--racon", "--racon_iter", "2",
             "--abundance_ratio", "0.005"])
        phase_gru(A, M, os.path.join(work, "gru"), pool20k)
        train_launches, train_pairs = phase_train(M, smi.splitlines()[0])
        dist_launches = phase_distributed(A, os.path.join(work, "dist"),
                                          pool20k, smi.splitlines()[0])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dryrun_launches = phase_dryrun(A, smi.splitlines()[0])

    log(f"chip_smoke wall: {time.perf_counter() - t_start} s")
    log(smi.splitlines()[0])

    def timed(kind):
        # the first shape (the larger launch) gives the headline numbers;
        # every shape's numbers stand under "shapes"
        head = times[kind][0]
        return dict(ms=head["ms"], plain_ms=head["plain_ms"],
                    bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                    shapes=times[kind],
                    launch_sizes=histogram(sizes[kind]))

    kernels = [
        dict(name="stats_kernel", route="cuda",
             source="ngspeciesid_tpu_torch/csrc/stats_kernel.cu",
             replaces="ngspeciesid_tpu/ops/align_stats_pallas.py:223",
             launches=launches["stats"], max_abs_err=stats_err,
             dist_launches=dist_launches, dryrun_launches=dryrun_launches,
             library_ms=None, **timed("stats")),
        dict(name="moves_kernel", route="cuda",
             source="ngspeciesid_tpu_torch/csrc/moves_kernel.cu",
             replaces="ngspeciesid_tpu/ops/align_moves_pallas.py:75",
             launches=launches["moves"], max_abs_err=moves_err,
             train_launches=train_launches, train_pairs=train_pairs,
             library_ms=None, **timed("moves")),
        dict(name="full_dp_kernel", route="cuda",
             source="ngspeciesid_tpu_torch/csrc/full_dp_kernel.cu",
             replaces="ngspeciesid_tpu/ops/align_pallas.py:45",
             launches=full_launches, library_ms=None, **full),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
