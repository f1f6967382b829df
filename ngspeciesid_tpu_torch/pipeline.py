"""Pipeline orchestrator (reference NGSpeciesID:36-158).

Port of ngspeciesid_tpu/pipeline.py: (1) score/filter/sort reads; (2) load
the empirical minimizer probability table; (3) wave-batched greedy
clustering (single pass, or the merge-tree sharded schedule when
nr_cores > 1); (4) cluster table output; (5) with --consensus, draft
consensus, trim, RC dedup and polish (the GRU polisher with
--medaka_model <params npz>).  With NGSID_DISTRIBUTED=1 stage 3 runs the
merge tree's shards on the ranks of a launcher such as ``torchrun``
(parallel/dist.py); its result is replicated, and every rank writes its
own outputs.
"""

from __future__ import annotations

import logging
import os
import random
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from .cluster.engine import GapPassTable, reads_to_clusters
from .cluster.store import ReadStore, build_store
from .config import Config
from .consensus.stage import run_consensus_stage
from .device import stats_backend_default, stats_device
from .io.fastx import mkdir_p, read_fastx
from .preprocess import score_and_sort
from .spans import sink, span
from .utils.ptable import load_p_table, p_table_as_matrix

logger = logging.getLogger(__name__)

ReadArray = List[Tuple[int, int, str, str, str, float]]


def load_read_array(sorted_path: str, cfg: Config) -> ReadArray:
    """Sorted fastq -> reference-shaped read tuples, with the optional
    length-window filter and subsampling (reference NGSpeciesID:54-63).

    seq/qual are uint8 buffer views (zero-decode, io/fastx.read_fastx_bytes);
    every downstream consumer (store build, shard balancing, engine) works on
    bytes — strings are materialized only at output edges."""
    from .io.fastx import read_fastx_bytes

    if cfg.target_length > 0 and cfg.target_deviation > 0:
        lo = cfg.target_length - cfg.target_deviation
        hi = cfg.target_length + cfg.target_deviation
        read_array = [
            (i, 0, acc, seq, qual, float(acc.split("_")[-1]))
            for i, (acc, seq, qual) in enumerate(read_fastx_bytes(sorted_path))
            if lo <= len(seq) <= hi
        ]
    else:
        read_array = [
            (i, 0, acc, seq, qual, float(acc.split("_")[-1]))
            for i, (acc, seq, qual) in enumerate(read_fastx_bytes(sorted_path))
        ]
    if cfg.top_reads:
        read_array = read_array[: cfg.sample_size]
    elif 0 < cfg.sample_size < len(read_array):
        # the reference samples with an unseeded RNG (NGSpeciesID:63); we
        # seed for reproducibility.
        rnd = random.Random(cfg.seed)
        keep = sorted(rnd.sample(range(len(read_array)), cfg.sample_size))
        read_array = [read_array[i] for i in keep]
    return read_array


def _cluster_stage_key(sorted_path: str, cfg: Config) -> str:
    """Content key of the clustering stage: sorted-reads digest + every
    parameter that can change cluster assignments (filters applied by
    load_read_array included, since they select the clustered set)."""
    from .artifacts import file_digest, stage_key

    return stage_key(file_digest(sorted_path), {
        "stage": "cluster", "k": cfg.k, "w": cfg.w,
        "min_shared": cfg.min_shared,
        "mapped_threshold": cfg.mapped_threshold,
        "aligned_threshold": cfg.aligned_threshold,
        "min_fraction": cfg.min_fraction,
        "min_prob_no_hits": cfg.min_prob_no_hits,
        "symmetric": cfg.symmetric_map_align_thresholds,
        "align_band": cfg.align_band,
        "target_length": cfg.target_length,
        "target_deviation": cfg.target_deviation,
        "sample_size": cfg.sample_size,
        "top_reads": cfg.top_reads,
        "seed": cfg.seed,
    })


def cluster_read_array(
    read_array: ReadArray, cfg: Config, sorted_path: Optional[str] = None
) -> Tuple[Dict[int, List[str]], ReadStore, List[int]]:
    """Stage 3: returns (clusters, store, surviving representative rows)."""
    cache = key = None
    if cfg.resume and sorted_path and cfg.outfolder:
        from .artifacts import ArtifactCache, load_clusters

        cache = ArtifactCache(cfg.outfolder)
        key = _cluster_stage_key(sorted_path, cfg)
        hit = cache.lookup("cluster", key)
        if hit is not None:
            logger.info("Resume: reusing clustering (inputs and parameters unchanged)")
            clusters = load_clusters(hit[0])
            store = build_store(read_array, cfg.k, cfg.w)
            return clusters, store, list(clusters.keys())
    with span("cluster.build"):
        p_matrix = p_table_as_matrix(load_p_table(cfg.k, cfg.w))
        store = build_store(read_array, cfg.k, cfg.w)
        max_gap = max((c.size for c in store.min_codes), default=1)
        gap_table = GapPassTable(p_matrix, cfg.min_prob_no_hits, max_gap)
    if os.environ.get("NGSID_DISTRIBUTED") == "1":
        # multi-process deployment: shards owned by the launcher's ranks,
        # per-round results exchanged via all-gather (parallel/dist.py);
        # result is replicated so every rank can write its own outputs.
        from .parallel.dist import distributed_clustering, launcher_comm
        with launcher_comm() as comm:
            clusters, alive = distributed_clustering(
                store, read_array, gap_table, cfg, comm)
    elif cfg.nr_cores > 1:
        from .parallel.merge import merge_tree_clustering
        clusters, alive = merge_tree_clustering(store, read_array, gap_table, cfg)
    else:
        clusters = {i: [acc] for i, _, acc, _, _, _ in read_array}
        clusters, alive, _ = reads_to_clusters(
            store, clusters, np.arange(len(read_array)), gap_table, cfg
        )
    if cache is not None:
        from .artifacts import save_clusters

        path = cache.path("clusters.json")
        save_clusters(path, clusters)
        cache.record("cluster", key, [path])
    return clusters, store, alive


def write_cluster_tables(
    clusters: Dict[int, List[str]], store: ReadStore, cfg: Config
) -> int:
    """final_clusters.tsv + final_cluster_origins.tsv, sorted by
    (cluster size, representative score) descending (NGSpeciesID:99-119)."""
    out_path = os.path.join(cfg.outfolder, "final_clusters.tsv")
    origins_path = os.path.join(cfg.outfolder, "final_cluster_origins.tsv")
    nontrivial = 0
    with open(out_path, "w") as out, open(origins_path, "w") as origins:
        output_cl_id = 0
        for c_id, accs in sorted(
            clusters.items(),
            key=lambda x: (len(x[1]), store.scores[store.row(x[0])]),
            reverse=True,
        ):
            row = store.row(c_id)
            acc_base = "_".join(store.accs[row].split("_")[:-1])
            origins.write(
                "{0}\t{1}\t{2}\t{3}\t{4}\t{5}\n".format(
                    output_cl_id, acc_base, store.seqs[row], store.quals[row],
                    float(store.scores[row]), float(store.error_rates[row]),
                )
            )
            for r_acc in sorted(accs, key=lambda x: float(x.split("_")[-1]), reverse=True):
                out.write("{0}\t{1}\n".format(output_cl_id, "_".join(r_acc.split("_")[:-1])))
            if len(accs) > 1:
                nontrivial += 1
            output_cl_id += 1
    return nontrivial


def run(cfg: Config, stage_walls: Optional[dict] = None) -> None:
    """Full pipeline (reference main, NGSpeciesID:36-158).

    ``stage_walls``: optional dict, the sink of the run's spans
    (``spans.py``): the host seconds of each span under its name (the
    stages ``stage1.sort``, ``run.load``, ``stage23.cluster``,
    ``stage3.tables``, ``stage4`` and its phases ``stage4.draft``,
    ``.trim``, ``.rc``, ``.polish``; inside them ``cluster.*``,
    ``merge.dump``, ``poa.*``, ``polish.files``, ``moves.*`` and
    ``stats.*``), the count ``poa.reads``, and under the older keys
    ``sort``, ``cluster``, ``consensus_polish`` and ``stage4_draft`` /
    ``_trim`` / ``_rc`` / ``_polish`` the seconds of ``stage1.sort``,
    ``stage23.cluster``, ``stage4`` and its phases (``stage4_*`` only with
    --consensus, ``stage4_trim`` 0 without trimming).  Raises RuntimeError
    when the cuda backend finds no CUDA device, before any work."""
    backend = stats_backend_default()
    if backend in ("cuda", "torch"):
        stats_device(backend)
    if stage_walls is None:
        stage_walls = {}
    mkdir_p(cfg.outfolder)
    profiling = bool(getattr(cfg, "profile", False))
    stage_log = logger.info if profiling else logger.debug
    prof = None
    if profiling:
        # host and device activity, viewable in Perfetto / chrome://tracing;
        # host stage wall-clocks are promoted to INFO alongside
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if backend == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    try:
        with sink(stage_walls):
            _run_stages(cfg, stage_walls, stage_log)
    finally:
        if prof is not None:
            prof.stop()
            trace_dir = os.path.join(cfg.outfolder, "profile")
            mkdir_p(trace_dir)
            trace = os.path.join(trace_dir, "trace.json")
            prof.export_chrome_trace(trace)
            logger.info("Profiling: trace -> %s", trace)


def _run_stages(cfg: Config, walls: dict, stage_log) -> None:
    with span("stage1.sort"):
        sorted_path = score_and_sort(cfg)
    walls["sort"] = walls["stage1.sort"]
    stage_log("elapsed time sorting: %.2fs", walls["sort"])
    with span("run.load"):
        read_array = load_read_array(sorted_path, cfg)
    abundance_cutoff = int(cfg.abundance_ratio * len(read_array))

    logger.info("Starting Clustering: %d reads", len(read_array))
    with span("stage23.cluster"):
        clusters, store, alive = cluster_read_array(read_array, cfg, sorted_path)
    walls["cluster"] = walls["stage23.cluster"]
    stage_log("Time elapsed clustering: %.2fs", walls["cluster"])
    with span("stage3.tables"):
        nontrivial = write_cluster_tables(clusters, store, cfg)
    logger.info("Finished Clustering: %d clusters formed", nontrivial)

    if cfg.consensus:
        logger.info("Starting Consensus creation and polishing")
        work_dir = tempfile.mkdtemp()
        logger.debug(
            "Forming draft consensus with abundance_cutoff >= %d (%s%% of %d reads)",
            abundance_cutoff, cfg.abundance_ratio * 100, len(read_array),
        )
        rep_scores = {int(store.ids[store.row(c)]): float(store.scores[store.row(c)])
                      for c in clusters}
        with span("stage4"):
            centers = run_consensus_stage(
                clusters, rep_scores, sorted_path, work_dir, abundance_cutoff,
                cfg)
        walls["consensus_polish"] = walls["stage4"]
        for phase in ("draft", "trim", "rc", "polish"):
            walls[f"stage4_{phase}"] = walls.get(f"stage4.{phase}", 0.0)
        stage_log("Time elapsed consensus+polish: %.2fs",
                  walls["consensus_polish"])
        shutil.rmtree(work_dir)
        logger.info("Finished Consensus creation: %d created", len(centers))


def write_fastq_subcommand(clusters_path: str, fastq: str, outfolder: str, n_min: int) -> None:
    """``write_fastq`` subcommand (reference NGSpeciesID:161-182)."""
    from collections import defaultdict

    clusters = defaultdict(list)
    with open(clusters_path) as f:
        for line in f:
            items = line.strip().split()
            clusters[items[0]].append(items[1])
    mkdir_p(outfolder)
    # keyed by the first whitespace token: the cluster table's whitespace
    # split only keeps that token, and the reference's full-header keying
    # (NGSpeciesID:172) KeyErrors on ONT headers with runid metadata.
    reads = {acc.split()[0]: (seq, qual) for acc, seq, qual in read_fastx(fastq)}
    for cl_id, accs in clusters.items():
        if len(accs) >= n_min:
            with open(os.path.join(outfolder, f"{cl_id}.fastq"), "w") as f:
                for acc in accs:
                    seq, qual = reads[acc]
                    f.write(f"@{acc}\n{seq}\n+\n{qual}\n")

