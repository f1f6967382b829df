"""Controls and planted faults: runs that the check has to call wrong.

A control breaks one guarantee that the configurations state, the way a
later change tempted by speed might; a fault breaks the timed path
underneath.  ``run.py --control NAME`` runs a cell with one of them on the
chip, and ``tests/test_bench_faults.py`` drives each through a whole run on
the CPU.  Each entry patches the program's module attributes and returns a
function that undoes the patch.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def _patch(module, name: str, make) -> Callable[[], None]:
    real = getattr(module, name)
    setattr(module, name, make(real))
    return lambda: setattr(module, name, real)


def no_fallback() -> Callable[[], None]:
    """Control: a read that fails the mapping test is never aligned; it
    becomes a representative (the alignment fallback skipped)."""
    from ngspeciesid_tpu_torch.cluster import engine

    return _patch(engine, "_run_alignments",
                  lambda real: lambda *a, **k: {})


def aligned_half() -> Callable[[], None]:
    """Control: the alignment test asks for an aligned ratio of 0.5 instead
    of the configured one (0.4 at the CLI's default)."""
    import dataclasses

    from ngspeciesid_tpu_torch.cluster import engine

    def make(real):
        def run(store, requests, cfg, *a, **k):
            return real(store, requests,
                        dataclasses.replace(cfg, aligned_threshold=0.5),
                        *a, **k)
        return run
    return _patch(engine, "_run_alignments", make)


def rep_consensus() -> Callable[[], None]:
    """Control: a cluster's consensus is its first read, neither folded
    into a draft nor polished."""
    from ngspeciesid_tpu_torch.consensus import stage

    undo = [_patch(stage, "msa_consensus_batch",
                   lambda real: lambda batch, max_reads=-1:
                   [np.asarray(reads[0], np.uint8) for reads in batch]),
            _patch(stage, "polish_round",
                   lambda real: lambda center, *a, **k: center)]
    return lambda: [u() for u in undo]


def half_consensus() -> Callable[[], None]:
    """Fault: stage 4 polishes and writes the first half of its centers
    (rounded down) and drops the rest."""
    from ngspeciesid_tpu_torch.consensus import stage

    return _patch(stage, "polish_sequences",
                  lambda real: lambda centers, cfg:
                  real(centers[: len(centers) // 2], cfg))


def stats_altered() -> Callable[[], None]:
    """Fault: one pair's statistics of every stats launch altered where the
    DP produces them (its window count one higher)."""
    from ngspeciesid_tpu_torch.ops import align_stats

    def make(real):
        def rows(*a, **k):
            out = real(*a, **k).clone()
            out[0, 4] += 1
            out[0, 12] += 1
            return out
        return rows
    return _patch(align_stats, "stats_rows", make)


def stats_half() -> Callable[[], None]:
    """Fault: every stats launch computes the first half of its pairs and
    hands their rows to the second half."""
    import torch

    from ngspeciesid_tpu_torch.ops import align_stats

    def make(real):
        def rows(pool, pm, *a, **k):
            B = pm.shape[0]
            half = max(1, (B + 1) // 2)
            got = real(pool, pm[:half].contiguous(), *a, **k)
            idx = torch.arange(B, device=got.device) % half
            return got[idx].contiguous()
        return rows
    return _patch(align_stats, "stats_rows", make)


def moves_altered() -> Callable[[], None]:
    """Fault: one pair's first traced op of every moves launch altered."""
    from ngspeciesid_tpu_torch.ops import align_moves

    def make(real):
        def rows(*a, **k):
            best, ops = real(*a, **k)
            ops = ops.clone()
            nz = (ops[0] != 0).nonzero()
            if nz.numel():
                j = int(nz[0, 0])
                ops[0, j] = 1 + int(ops[0, j]) % 3
            return best, ops
        return rows
    return _patch(align_moves, "moves_rows", make)


def decision_altered() -> Callable[[], None]:
    """Fault: the alignment fallback's last winner of every batch dropped."""
    from ngspeciesid_tpu_torch.cluster import engine

    def make(real):
        def run(*a, **k):
            winners = real(*a, **k)
            if winners:
                winners.pop(max(winners))
            return winners
        return run
    return _patch(engine, "_run_alignments", make)


def sorted_altered() -> Callable[[], None]:
    """Fault: the two best reads of ``sorted.fastq`` swapped."""
    from ngspeciesid_tpu_torch import pipeline

    def make(real):
        def run(cfg):
            path = real(cfg)
            with open(path, "rb") as f:
                lines = f.read().split(b"\n")
            if len(lines) >= 9:
                lines[0:4], lines[4:8] = lines[4:8], lines[0:4]
            with open(path, "wb") as f:
                f.write(b"\n".join(lines))
            return path
        return run
    return _patch(pipeline, "score_and_sort", make)


def consensus_altered() -> Callable[[], None]:
    """Fault: every 20th base of each polished consensus changed."""
    from ngspeciesid_tpu_torch.consensus import stage

    def make(real):
        def run(center, *a, **k):
            out = np.array(real(center, *a, **k), np.uint8)
            out[::20] = np.where(out[::20] == ord("A"), ord("C"), ord("A"))
            return out
        return run
    return _patch(stage, "polish_round", make)


CONTROLS: Dict[str, Callable[[], Callable[[], None]]] = {
    "no_fallback": no_fallback,
    "aligned_half": aligned_half,
    "rep_consensus": rep_consensus,
}
FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    "stats_altered": stats_altered,
    "stats_half": stats_half,
    "moves_altered": moves_altered,
    "decision_altered": decision_altered,
    "sorted_altered": sorted_altered,
    "consensus_altered": consensus_altered,
    "half_consensus": half_consensus,
}
