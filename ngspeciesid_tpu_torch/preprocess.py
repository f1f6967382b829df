"""Stage 1: score, filter and sort reads (reference
modules/get_sorted_fastq_for_cluster.py:124-191).

Pipeline contract reproduced:
  * drop reads with ``len(seq) < 2*k`` or homopolymer-compressed length < k;
  * drop reads whose average phred error rate e satisfies
    ``10 * -log10(e) <= quality_threshold``;
  * score survivors by the expected number of error-free k-mers and sort
    descending (stable);
  * write ``<outfolder>/sorted.fastq`` with the float64 score appended to each
    accession as ``{acc}_{score}`` (str(float) formatting — byte-compatible);
  * write ``<outfolder>/logfile.txt`` with min/max/median/mean error rates.

Scoring is batched (ops/score.py) instead of per-read Python loops; buckets
are length-sorted to bound padding waste.
"""

from __future__ import annotations

import logging
import os
from typing import List, Tuple

import numpy as np

from .config import Config
from .io.fastx import read_fastx
from .ops.score import batch_error_rates, batch_scores
from .utils.seqs import hpol_compress_bytes, seq_bytes
from .utils.phred import qual_bytes

logger = logging.getLogger(__name__)

_SCORE_BUCKET = 4096


def _stage1_key(cfg: Config) -> str:
    from .artifacts import file_digest, stage_key

    return stage_key(file_digest(cfg.fastq), {
        "stage": "sort", "k": cfg.k,
        "quality_threshold": cfg.quality_threshold,
    })


def score_and_sort(cfg: Config) -> str:
    """Run stage 1; returns the path of the sorted fastq file."""
    outfile = os.path.join(cfg.outfolder, "sorted.fastq")
    logfile_path = os.path.join(cfg.outfolder, "logfile.txt")
    cache = key = None
    if cfg.resume:
        from .artifacts import ArtifactCache

        cache = ArtifactCache(cfg.outfolder)
        key = _stage1_key(cfg)
        hit = cache.lookup("sort", key)
        if hit is not None and os.path.isfile(outfile):
            logger.info("Resume: reusing sorted.fastq (input and parameters unchanged)")
            return outfile
    # The reference truncates logfile.txt before the reuse check
    # (get_sorted_fastq_for_cluster.py:161-164); mirror that.
    logfile = open(logfile_path, "w")
    if os.path.isfile(outfile) and cfg.use_old_sorted_file:
        logger.warning(
            "Using already existing sorted file in specified directory, "
            "if not intended, specify different outfolder or delete the current file."
        )
        logfile.close()
        return outfile

    k = cfg.k
    from . import native

    if native.available() and os.environ.get("NGSID_STAGE1") != "python":
        if _score_sort_bytes(cfg, outfile, logfile):
            if cache is not None:
                cache.record("sort", key, [outfile])
            return outfile

    names: List[str] = []
    seqs: List[str] = []
    quals: List[str] = []
    qual_arrays: List[np.ndarray] = []
    seq_arrays: List[np.ndarray] = []
    for name, seq, qual in read_fastx(cfg.fastq):
        if qual is None:
            continue
        if len(seq) < 2 * k:
            continue
        names.append(name)
        seqs.append(seq)
        quals.append(qual)
        qual_arrays.append(qual_bytes(qual))
        seq_arrays.append(seq_bytes(seq))

    n = len(names)
    scores = np.empty(n, dtype=np.float64)
    error_rates = np.empty(n, dtype=np.float64)
    hpol_ok = np.empty(n, dtype=bool)
    # Bucket by length (descending) so padding in the batched scorer is small.
    order = np.argsort([-q.size for q in qual_arrays], kind="stable")

    from . import native
    from .utils.phred import PHRED_TO_P, PHRED_TO_P_CAPPED

    use_native = native.available() and os.environ.get("NGSID_STAGE1") != "python"
    for s in range(0, n, _SCORE_BUCKET):
        idx = order[s : s + _SCORE_BUCKET]
        batch = [qual_arrays[i] for i in idx]
        if use_native:
            # fused single pass per read: score + error rate + hpol length
            # (bit-identical to the numpy path; tests/test_stage1.py)
            sc, er, hl = native.stage1_stats_native(
                [seq_arrays[i] for i in idx], batch, k,
                PHRED_TO_P_CAPPED, PHRED_TO_P)
            scores[idx] = sc
            error_rates[idx] = er
            hpol_ok[idx] = hl >= k
        else:
            scores[idx] = batch_scores(batch, k)
            error_rates[idx] = batch_error_rates(batch, capped=False)
            hpol_ok[idx] = [
                hpol_compress_bytes(seq_arrays[i]).size >= k for i in idx
            ]

    # Quality filter: keep reads with 10 * -log10(e) > q_threshold
    # (reference get_sorted:64,147; math.log(e, 10) == log(e)/log(10)).
    with np.errstate(divide="ignore"):
        q_vals = 10.0 * -(np.log(error_rates) / np.log(10.0))
    keep = hpol_ok & (q_vals > cfg.quality_threshold)

    kept_idx = np.flatnonzero(keep)
    kept_scores = scores[kept_idx]
    sort_order = np.argsort(-kept_scores, kind="stable")
    final_idx = kept_idx[sort_order]

    with open(outfile, "w") as f:
        for i in final_idx:
            f.write(f"@{names[i]}_{float(scores[i])!r}\n{seqs[i]}\n+\n{quals[i]}\n")

    logger.debug(
        "%d reads passed quality critera (avg phred Q val over %s and length > 2*k) "
        "and will be clustered.",
        len(final_idx), cfg.quality_threshold,
    )

    _write_error_rate_log(logfile, error_rates[kept_idx])
    if cache is not None:
        cache.record("sort", key, [outfile])
    return outfile


def _write_error_rate_log(logfile, kept_err: np.ndarray) -> None:
    kept_err = np.sort(kept_err)
    if kept_err.size:
        # Mean over ascending values, sequential sum — matches the reference's
        # post-sort sum (get_sorted:179-183) deterministically.
        mean_e = float(np.cumsum(kept_err)[-1] / kept_err.size)
        logfile.write("Lowest read error rate:{0}\n".format(float(kept_err[0])))
        logfile.write("Highest read error rate:{0}\n".format(float(kept_err[-1])))
        logfile.write("Median read error rate:{0}\n".format(float(kept_err[kept_err.size // 2])))
        logfile.write("Mean read error rate:{0}\n".format(mean_e))
        logfile.write("\n")
    logfile.close()


def _score_sort_bytes(cfg: Config, outfile: str, logfile) -> bool:
    """Zero-decode stage 1 for strict 4-line fastq: the file is scanned once
    into byte-range tables (io/fastx.scan_fastq), per-read stats come from
    the fused native kernel over buffer views, and sorted.fastq is assembled
    from buffer slices — no per-read str objects.  Output is byte-identical
    to the string path (tests/test_stage1.py).  Returns False when the input
    needs the general readfq parser."""
    from . import native
    from .io.fastx import scan_fastq
    from .utils.phred import PHRED_TO_P, PHRED_TO_P_CAPPED

    scan = scan_fastq(cfg.fastq)
    if scan is None:
        return False
    data, starts, ends = scan
    arr = np.frombuffer(data, dtype=np.uint8)
    k = cfg.k
    seq_lens = ends[:, 1] - starts[:, 1]
    rows = np.flatnonzero(seq_lens >= 2 * k)

    n = rows.size
    scores = np.empty(n, dtype=np.float64)
    error_rates = np.empty(n, dtype=np.float64)
    hpol_ok = np.empty(n, dtype=bool)
    # Bucket by length (descending) so padding in the staging matrix is small.
    order = np.argsort(-seq_lens[rows], kind="stable")
    for s in range(0, n, _SCORE_BUCKET):
        idx = order[s : s + _SCORE_BUCKET]
        sc, er, hl = native.stage1_stats_native(
            [arr[starts[r, 1] : ends[r, 1]] for r in rows[idx]],
            [arr[starts[r, 3] : ends[r, 3]] for r in rows[idx]],
            k, PHRED_TO_P_CAPPED, PHRED_TO_P)
        scores[idx] = sc
        error_rates[idx] = er
        hpol_ok[idx] = hl >= k

    with np.errstate(divide="ignore"):
        q_vals = 10.0 * -(np.log(error_rates) / np.log(10.0))
    keep = hpol_ok & (q_vals > cfg.quality_threshold)
    kept_idx = np.flatnonzero(keep)
    final_idx = kept_idx[np.argsort(-scores[kept_idx], kind="stable")]

    with open(outfile, "wb") as f:
        parts: List[bytes] = []
        for i in final_idx:
            r = rows[i]
            parts.append(b"@%s_%s\n%s\n+\n%s\n" % (
                data[starts[r, 0] : ends[r, 0]],
                repr(float(scores[i])).encode("ascii"),
                data[starts[r, 1] : ends[r, 1]],
                data[starts[r, 3] : ends[r, 3]],
            ))
            # chunk-joined writes: per-record BufferedWriter calls cost more
            # than the formatting at millions of reads
            if len(parts) >= 8192:
                f.write(b"".join(parts))
                parts = []
        f.write(b"".join(parts))

    logger.debug(
        "%d reads passed quality critera (avg phred Q val over %s and length > 2*k) "
        "and will be clustered.",
        len(final_idx), cfg.quality_threshold,
    )
    _write_error_rate_log(logfile, error_rates[kept_idx])
    return True
