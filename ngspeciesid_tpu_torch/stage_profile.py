"""Where a run's time goes on one GPU: stage walls, host functions and the
kernels' device time.

    python -m ngspeciesid_tpu_torch.stage_profile [--n_reads 20000]
        [--n_species 50] [--top 30] [CLI flags ...]

Simulates a pool with the port's simulator (700 bp, 7% error, seed 0) into
a temporary directory and runs the CLI on the cuda backend three times,
with the given CLI flags (default ``--ont --consensus --medaka
--abundance_ratio 0.005``): plain, for the stage walls; under cProfile, for
the host functions by cumulative time; and under torch.profiler, for the
device time by kernel and the device's busy share of the run.  Needs a
CUDA device; prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time

import torch

DEFAULT_FLAGS = ["--ont", "--consensus", "--medaka", "--abundance_ratio",
                 "0.005"]


def _device_us(evt) -> float:
    """Device microseconds of a device-side event (kernel, copy, memset);
    0 for host ops, whose totals would count their kernels twice."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_reads", type=int, default=20000)
    ap.add_argument("--n_species", type=int, default=50)
    ap.add_argument("--top", type=int, default=30)
    args, flags = ap.parse_known_args(argv)
    flags = flags or DEFAULT_FLAGS
    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device", file=sys.stderr)
        return 1
    from . import cli
    from .ops import align_moves, align_stats, cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    cuda_lib.load()
    os.environ["NGSID_STATS_BACKEND"] = "cuda"
    work = tempfile.mkdtemp(prefix="stage_profile_")
    try:
        pool = os.path.join(work, "pool.fastq")
        subprocess.run(
            [sys.executable, "-m", "ngspeciesid_tpu_torch.simulate", "--out",
             pool, "--n_reads", str(args.n_reads), "--n_species",
             str(args.n_species), "--length", "700", "--error", "0.07",
             "--seed", "0"], check=True, stdout=subprocess.DEVNULL,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

        def run(tag):
            walls: dict = {}
            align_stats.reset_counts()
            align_moves.reset_counts()
            t0 = time.perf_counter()
            rc = cli.main([*flags, "--fastq", pool, "--outfolder",
                           os.path.join(work, tag)], stage_walls=walls)
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"CLI exited {rc}")
            return time.perf_counter() - t0, walls

        wall, walls = run("plain")
        print(f"plain run: wall {wall} s, stage walls {json.dumps(walls)}, "
              f"stats launches/pairs {align_stats.LAUNCHES}/"
              f"{align_stats.PAIRS}, moves launches/pairs "
              f"{align_moves.LAUNCHES}/{align_moves.PAIRS}", flush=True)

        prof = cProfile.Profile()
        prof.enable()
        wall, walls = run("cprofile")
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(
            args.top)
        print(f"cProfile run: wall {wall} s, stage walls {json.dumps(walls)}")
        print(out.getvalue(), flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as tp:
            wall, walls = run("torch_profiler")
        device = sorted(((e.key, _device_us(e), e.count)
                         for e in tp.key_averages() if _device_us(e) > 0),
                        key=lambda x: -x[1])
        total = sum(us for _, us, _ in device)
        print(f"torch.profiler run: wall {wall} s, stage walls "
              f"{json.dumps(walls)}; device time {total / 1e6} s, busy "
              f"{total / 1e6 / wall} of the wall")
        for key, us, count in device[: args.top]:
            print(f"  {us / 1e3:12.3f} ms  {count:7d}x  {key[:100]}")
        if not device:
            print(tp.key_averages().table(row_limit=args.top))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
