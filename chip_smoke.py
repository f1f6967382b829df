#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ngspeciesid_tpu_torch) on one GPU.

Run from the repository root, with no arguments and no install:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Device and build: requires CUDA, builds csrc/*.cu with nvcc, prints the
   build time, the ptxas report and the card's name and power limit.
2. Kernel against its plain PyTorch version, on the card: raw (B, 16)
   endpoint rows bit-equal on seeded pairs over lengths {90-120, 300-500,
   500-800, 1100-1400}, k {13, 20, 26}, band {0, 150}, batch 8, and at the
   main path's shape (4096 pairs, ~700 bp, band 150, k 13).  At band 0 the
   finalized statistics must also equal the numpy oracle.  Times both
   versions per launch at the main path's shape (CUDA events, warm, median).
3. Main path: simulates a 20,000-read pool (50 species, 700 bp, 7% error),
   runs the CLI in-process with the default backend (cuda) and with the
   native C++ engine, and requires sorted.fastq, final_clusters.tsv and
   final_cluster_origins.tsv to be byte-equal, and the kernel's pair count
   to equal the pairs the engine asked for.

The last two lines of standard output are the kernels' JSON line and
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUTPUTS = ("sorted.fastq", "final_clusters.tsv", "final_cluster_origins.tsv")
KERNEL_SOURCE = "ngspeciesid_tpu_torch/csrc/stats_kernel.cu"
KERNEL_REPLACES = "ngspeciesid_tpu/ops/align_stats_pallas.py:223"
#: (pairs, min length, max length, k, band) of the kernel-vs-plain cases;
#: the last is the main path's launch shape.
KERNEL_CASES = [(8, lo, hi, k, band)
                for lo, hi in ((90, 120), (300, 500), (500, 800), (1100, 1400))
                for k in (13, 20, 26) for band in (0, 150)] + [
                    (4096, 650, 750, 13, 150)]


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


def phase_kernel(A, dev, cases=KERNEL_CASES):
    """Phase 2: kernel rows against the plain version's, bit for bit."""
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
                    f"kernel rows differ from the plain version: B={B} "
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
                            f"kernel statistics differ from the numpy oracle "
                            f"(len {lo}-{hi} k={k}): {res[t]} != {want3}")
            if (B, lo, hi, k, band) == main_shape and sl is chunks[0]:
                def kern():
                    A.stats_rows(pool.buf, pm, base, W, d_max, band)

                def plain():
                    A.stats_rows_plain(pool.buf, pm, base, W, d_max, band)

                ms = time_cuda(kern, 9)
                plain_ms = time_cuda(plain, 3)
                timing = (len(sl), W, d_max, ms, plain_ms)
        log(f"kernel == plain: B={B} len {lo}-{hi} k={k} band={band} "
            f"({len(chunks)} chunk{'s' * (len(chunks) > 1)})")
    B, W, d_max, ms, plain_ms = timing
    log(f"main-path shape ({B} pairs, ~700 bp, band 150, k 13, W={W}, "
        f"{d_max} diagonals): kernel {ms} ms/launch, plain "
        f"{plain_ms} ms/launch")
    return max_err, ms, plain_ms


def warm_native():
    """Build the shared C++ engine (g++, at first use) before the timed
    runs, so that neither main-path run pays for it."""
    import numpy as np

    from ngspeciesid_tpu_torch.ops.align import block_stats_batch

    a = np.frombuffer(b"ACGTACGTTGCA" * 8, np.uint8)
    block_stats_batch([(a, a)], [3], [13], [9], backend="native")


def phase_main_path(A, work, n_reads=20000):
    """Phase 3: the CLI on a simulated pool, cuda against native."""
    from ngspeciesid_tpu_torch import cli
    from ngspeciesid_tpu_torch.cluster import engine

    pool = os.path.join(work, "pool.fastq")
    subprocess.run(
        [sys.executable, os.path.join(HERE, "scripts", "simulate_reads.py"),
         "--out", pool, "--n_reads", str(n_reads), "--n_species", "50",
         "--length", "700", "--error", "0.07", "--seed", "0"],
        check=True, cwd=HERE, stdout=subprocess.DEVNULL)
    requested = [0]
    engine_call = A.sg_stats_pool_torch

    def counted(seqs, rows1, *args, **kwargs):
        requested[0] += len(rows1)
        return engine_call(seqs, rows1, *args, **kwargs)

    results = {}
    for backend in ("cuda", "native"):
        out = os.path.join(work, backend)
        os.environ["NGSID_STATS_BACKEND"] = backend
        walls = {}
        A.sg_stats_pool_torch = counted
        A.reset_counts()
        engine.reset_perf_counters()
        t0 = time.perf_counter()
        try:
            rc = cli.main(["--ont", "--fastq", pool, "--outfolder", out],
                          stage_walls=walls)
        finally:
            A.sg_stats_pool_torch = engine_call
        if backend == "cuda":
            import torch

            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"CLI with backend {backend} exited {rc}")
        with open(os.path.join(out, "final_cluster_origins.tsv")) as f:
            n_clusters = sum(1 for _ in f)
        results[backend] = (A.LAUNCHES, A.PAIRS, requested[0])
        log(f"main path [{backend}]: wall {wall} s, sort "
            f"{walls['sort']} s, cluster {walls['cluster']} s, "
            f"{n_clusters} clusters, kernel launches {A.LAUNCHES}, "
            f"kernel pairs {A.PAIRS}, engine pairs {requested[0]}, engine "
            f"phases {json.dumps(engine.PERF_COUNTERS)}")
        requested[0] = 0
    del os.environ["NGSID_STATS_BACKEND"]
    for name in OUTPUTS:
        with open(os.path.join(work, "cuda", name), "rb") as f:
            a = f.read()
        with open(os.path.join(work, "native", name), "rb") as f:
            b = f.read()
        if not a or a != b:
            raise AssertionError(f"{name} differs between cuda and native")
        log(f"{name}: byte-equal between cuda and native ({len(a)} bytes)")
    launches, pairs, asked = results["cuda"]
    if launches == 0 or pairs != asked:
        raise AssertionError(f"kernel ran {pairs} pairs in {launches} "
                             f"launches, engine asked for {asked}")
    if results["native"][:2] != (0, 0):
        raise AssertionError("the native run launched the kernel")
    return launches


def main():
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

    max_err, ms, plain_ms = phase_kernel(A, dev)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_main_path(A, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(smi.splitlines()[0])
    log(json.dumps({"kernels": [{
        "name": "stats_kernel", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
