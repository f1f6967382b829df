#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ngspeciesid_tpu_torch) on one GPU.

Run from the repository root, with no arguments and no install:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Device and build: requires CUDA, builds csrc/*.cu with nvcc (one process
   per source, all at once), prints the build time, the ptxas report of
   both kernels and the card's name and power limit.
2. Each kernel against its plain PyTorch version, on the card:
   a. stats kernel: raw (B, 16) endpoint rows bit-equal on seeded pairs over
      lengths {90-120, 300-500, 500-800, 1100-1400}, k {13, 20, 26}, band
      {0, 150}, batch 8, and at the clustering path's shape (4096 pairs,
      ~700 bp, band 150, k 13).  At band 0 the finalized statistics must
      also equal the numpy oracle.
   b. moves kernel: raw endpoint rows and op streams bit-equal over the
      same lengths, band {0, 150}, POA and clustering scoring, mutated and
      unrelated pairs.  At band 0 the reconstructed moves must also equal
      the numpy oracle.
   Each is timed against its plain version per launch at the main path's
   shape (CUDA events, warm, median): the stats kernel at 4096 pairs, the
   moves kernel at the polish shape (one ~700 bp center against 512 reads
   of 650-750 bp, band 150, POA scoring).
3. Main path: simulates a 20,000-read pool (50 species, 700 bp, 7% error)
   with the port's simulator and runs the CLI in-process with
   --consensus --medaka, on the default backend (cuda) and on the native
   C++ engine.  Every output file must be byte-equal; each kernel's pair
   count must equal the pairs its callers asked for; both kernels must
   have launched in the cuda run and neither in the native run.  A second
   run (5,000 reads, 20 species, --consensus --racon --racon_iter 2)
   covers the racon files, PAFs included, the same way.

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
                   (4096, 650, 750, 13, 150)]
#: (pairs, min length, max length, band, POA scoring) of the moves kernel's
#: cases; half of each batch mutated copies, half unrelated pairs.
MOVES_CASES = [(8, lo, hi, band, poa)
               for lo, hi in ((90, 120), (300, 500), (500, 800), (1100, 1400))
               for band in (0, 150) for poa in (True, False)]
#: H100 SXM peaks (NVIDIA's H100 data sheet and architecture white paper):
#: device memory bytes per second and int32 operations per second.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
#: int32 operations the DP must do per in-band cell.  Moves: the Gotoh
#: recurrence (E: 2 sub + max; F: 2 sub + max; diagonal: compare + add;
#: H: 2 max) and the move byte (2 compares for the layer, 2 for the
#: gap-open bits).  Stats: the same 9 score operations plus one push of the
#: path fields per layer (hist shift, or, mask; popcount; colcount add;
#: 2 compares and an and for the window; wcount and mcount adds) x 3 layers.
MOVES_OPS_PER_CELL = 13
STATS_OPS_PER_CELL = 9 + 3 * 10


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


def phase_stats_kernel(A, dev, cases=STATS_CASES):
    """Phase 2a: stats kernel rows against the plain version's, bit for bit."""
    import numpy as np
    import torch

    from ngspeciesid_tpu_torch.ops.align import (
        block_aligned_stats, identity_from_moves, match_vector, sg_align_batch)

    rng = np.random.default_rng(0)
    main_shape = cases[-1]
    max_err = 0
    timing = None
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
            if not torch.equal(got, want):
                bad = (got != want).any(1).nonzero().flatten().tolist()
                raise AssertionError(
                    f"stats kernel rows differ from the plain version: B={B} "
                    f"len {lo}-{hi} k={k} band={band} W={W} pairs {bad[:8]}")
            if band == 0 and B <= 8:
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
            if (B, lo, hi, k, band) == main_shape and sl is chunks[0]:
                def kern():
                    A.stats_rows(pool.buf, pm, base, W, d_max, band)

                def plain():
                    A.stats_rows_plain(pool.buf, pm, base, W, d_max, band)

                ms = time_cuda(kern, 9)
                plain_ms = time_cuda(plain, 3)
                # bytes: both sequences, the pair table and the window
                # schedule in, the endpoint rows out
                nbytes = (int((len1 + len2).sum()) + pm.numel() * 8
                          + base.numel() * 4 + len(sl) * 16 * 4)
                cells = band_cells(A, pm, d_max, band)
                bound, by = bound_ms(nbytes, cells * STATS_OPS_PER_CELL)
                timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=by)
                log(f"stats kernel at the clustering shape ({len(sl)} pairs, "
                    f"~700 bp, band 150, k 13, W={W}, {d_max} diagonals, "
                    f"{cells} in-band cells, {nbytes} bytes): kernel {ms} "
                    f"ms/launch, plain {plain_ms} ms/launch, bound {bound} "
                    f"ms ({by})")
        log(f"stats kernel == plain: B={B} len {lo}-{hi} k={k} band={band} "
            f"({len(chunks)} chunk{'s' * (len(chunks) > 1)})")
    return dict(max_abs_err=max_err, **timing)


def phase_moves_kernel(A, M, dev, cases=MOVES_CASES):
    """Phase 2b: moves kernel rows and op streams against the plain
    version's, bit for bit, and its time at the polish shape."""
    import numpy as np
    import torch

    from ngspeciesid_tpu_torch.ops.align import sg_align_batch
    from ngspeciesid_tpu_torch.ops.poa import (
        POA_BAND, POA_EXT, POA_MATCH, POA_MISMATCH, POA_OPEN)

    rng = np.random.default_rng(1)
    max_err = 0

    def run(seqs, r1, r2, opens, band, scoring):
        pool = A.SeqPool(dev)
        pool.ensure(seqs)
        B = len(r1)
        pm, base, W, d_max, len1, len2 = A.stage_chunk(
            pool, seqs, r1, r2, opens, [0] * B, [0] * B, band)
        args = (pool.buf, pm, base, W, d_max, band, *scoring)
        return args, len1, len2

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
            args, len1, len2 = run(seqs, c1, c2, co, band, scoring)
            best, ops = M.moves_rows(*args)
            p_best, p_ops = M.moves_rows_plain(*args)
            torch.cuda.synchronize()
            err = max(int((best.long() - p_best.long()).abs().max()),
                      int((ops.long() - p_ops.long()).abs().max()))
            max_err = max(max_err, err)
            if not (torch.equal(best, p_best) and torch.equal(ops, p_ops)):
                bad = ((best != p_best).any(1) | (ops != p_ops).any(1)
                       ).nonzero().flatten().tolist()
                raise AssertionError(
                    f"moves kernel differs from the plain version: B={B} "
                    f"len {lo}-{hi} band={band} poa={poa} pairs {bad[:8]}")
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
        log(f"moves kernel == plain: B={B} len {lo}-{hi} band={band} "
            f"{'POA' if poa else 'clustering'} scoring "
            f"({len(chunks)} chunk{'s' * (len(chunks) > 1)})")

    # the polish shape: one center against 512 reads, one chunk
    center = rng.integers(65, 69, size=700).astype(np.uint8)
    reads = []
    while len(reads) < 512:
        r = mutate(rng, center, 0.07)
        if 650 <= r.size <= 750:
            reads.append(r)
    seqs = [center] + reads
    r2 = list(range(1, len(seqs)))
    assert len(M._plan(seqs, [0] * 512, r2)) == 1
    args, len1, len2 = run(seqs, [0] * 512, r2, [POA_OPEN] * 512, POA_BAND,
                           (POA_MATCH, POA_MISMATCH, POA_EXT))
    pool_buf, pm, base, W, d_max = args[:5]
    best, ops = M.moves_rows(*args)
    p_best, p_ops = M.moves_rows_plain(*args)
    if not (torch.equal(best, p_best) and torch.equal(ops, p_ops)):
        raise AssertionError("moves kernel differs from the plain version at "
                             "the polish shape")
    ms = time_cuda(lambda: M.moves_rows(*args), 9)
    plain_ms = time_cuda(lambda: M.moves_rows_plain(*args), 3)
    cells = band_cells(A, pm, d_max, POA_BAND)
    # bytes: the center once and every read, the pair table and the window
    # schedule in; the endpoint rows and op streams out; and the move store,
    # one byte per in-band cell, counted once
    nbytes = (center.size + int(len2.sum()) + pm.numel() * 8
              + base.numel() * 4 + 512 * 16 * 4 + ops.numel() + cells)
    bound, by = bound_ms(nbytes, cells * MOVES_OPS_PER_CELL)
    log(f"moves kernel at the polish shape (512 pairs, 700 bp center, reads "
        f"650-750 bp, band {POA_BAND}, W={W}, {d_max} diagonals, {cells} "
        f"in-band cells, {nbytes} bytes): kernel {ms} ms/launch, plain "
        f"{plain_ms} ms/launch, bound {bound} ms ({by})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by)


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


def run_backends(A, M, work, pool, args):
    """The CLI on ``pool`` with ``args``, on cuda and on native: every
    output file byte-equal, kernel pairs equal to the pairs asked for, both
    kernels launched on cuda and neither on native.  Returns the cuda run's
    kernel launches."""
    from ngspeciesid_tpu_torch import cli
    from ngspeciesid_tpu_torch.cluster import engine

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
        results[backend] = (counts, dict(asked))
        log(f"[{backend}] {' '.join(args)}: wall {wall} s, stage walls "
            f"{json.dumps(walls)}, kernel launches/pairs {json.dumps(counts)}"
            f", pairs asked {json.dumps(asked)}, engine phases "
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
    counts, asked_cuda = results["cuda"]
    for kind in ("stats", "moves"):
        launches, pairs = counts[kind]
        if launches == 0 or pairs != asked_cuda[kind]:
            raise AssertionError(
                f"{kind} kernel ran {pairs} pairs in {launches} launches, "
                f"its callers asked for {asked_cuda[kind]}")
        if results["native"][0][kind] != (0, 0):
            raise AssertionError(f"the native run launched the {kind} kernel")
    return {kind: counts[kind][0] for kind in counts}


def simulate(out, n_reads, n_species):
    subprocess.run(
        [sys.executable, "-m", "ngspeciesid_tpu_torch.simulate", "--out", out,
         "--n_reads", str(n_reads), "--n_species", str(n_species),
         "--length", "700", "--error", "0.07", "--seed", "0"],
        check=True, cwd=HERE, stdout=subprocess.DEVNULL)


def main():
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "ngspeciesid_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(ngspeciesid_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
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
    t0 = time.perf_counter()
    warm_native()
    log(f"native engine build and load: {time.perf_counter() - t0} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"card: {smi.splitlines()[0]}")

    stats = phase_stats_kernel(A, dev)
    moves = phase_moves_kernel(A, M, dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        pool = os.path.join(work, "pool20k.fastq")
        simulate(pool, 20000, 50)
        launches = run_backends(
            A, M, os.path.join(work, "medaka"), pool,
            ["--ont", "--consensus", "--medaka", "--abundance_ratio", "0.005"])
        pool = os.path.join(work, "pool5k.fastq")
        simulate(pool, 5000, 20)
        run_backends(
            A, M, os.path.join(work, "racon"), pool,
            ["--ont", "--consensus", "--racon", "--racon_iter", "2",
             "--abundance_ratio", "0.005"])
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(f"chip_smoke wall: {time.perf_counter() - t_start} s")
    log(smi.splitlines()[0])
    kernels = [
        dict(name="stats_kernel", route="cuda",
             source="ngspeciesid_tpu_torch/csrc/stats_kernel.cu",
             replaces="ngspeciesid_tpu/ops/align_stats_pallas.py:223",
             launches=launches["stats"], library_ms=None, **stats),
        dict(name="moves_kernel", route="cuda",
             source="ngspeciesid_tpu_torch/csrc/moves_kernel.cu",
             replaces="ngspeciesid_tpu/ops/align_moves_pallas.py:75",
             launches=launches["moves"], library_ms=None, **moves),
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
