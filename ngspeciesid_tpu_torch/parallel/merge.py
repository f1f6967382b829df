"""Hierarchical merge-tree clustering schedule.

Reproduces the reference's multiprocessing clustering topology (reference
modules/parallelize.py:33-217) on top of the wave-batched engine: the read
array is split into ``nr_cores`` work-balanced shards, each shard is
clustered independently, surviving representatives are re-sorted by score and
consecutive shard pairs merge — carrying the minimizer database of the pair's
lowest shard so its representatives are not re-scored — until one shard
remains.

The reference runs shards in spawn-Pool worker processes; here each shard is
a device-batched engine pass (and, on a multi-host deployment, shards map to
hosts with the merged representative set exchanged via collectives — see
parallel/dist.py).  The schedule, skip logic, and outputs (per-iteration
``{it}/pre_clusters.csv`` + ``cluster_origins.csv`` dumps) are semantically
identical.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from ngspeciesid_tpu.config import Config
from ngspeciesid_tpu.cluster.store import ReadStore
from ngspeciesid_tpu.io.fastx import mkdir_p

from ..cluster.engine import GapPassTable, MinimizerDB, reads_to_clusters

logger = logging.getLogger(__name__)

ReadTuple = Tuple[int, int, str, str, str, float]


def batch_list(
    lst: Sequence[ReadTuple],
    nr_cores: int = 1,
    batch_type: str = "nr_reads",
    merge_consecutive: bool = False,
) -> Iterator[List[ReadTuple]]:
    """Shard splitter (reference parallelize.py:33-81).

    batch types: ``nr_reads`` (equal counts), ``total_nt`` (equal total
    length), ``read_lengths_squared`` (equal sum of squared lengths — the
    quadratic-alignment-cost balancer).  ``merge_consecutive`` pairs shards
    (1,2), (3,4), ... by walking the score-sorted list and closing a shard
    when a read's previous batch index exceeds the rolling threshold.
    """
    if merge_consecutive:
        batch_id = 2
        batch: List[ReadTuple] = []
        for info in lst:
            if info[1] <= batch_id:
                batch.append(info)
            else:
                yield batch
                batch_id += 2
                batch = [info]
        yield batch
        return
    if batch_type == "nr_reads":
        l = len(lst)
        chunk = l // nr_cores + 1
        for ndx in range(0, l, chunk):
            yield list(lst[ndx : min(ndx + chunk, l)])
    elif batch_type == "total_nt":
        tot = sum(len(r[3]) for r in lst)
        chunk = tot // nr_cores + 1
        batch, cur = [], 0
        for info in lst:
            cur += len(info[3])
            batch.append(info)
            if cur >= chunk:
                yield batch
                batch, cur = [], 0
        yield batch
    elif batch_type == "read_lengths_squared":
        tot = sum(math.pow(len(r[3]), 2) for r in lst)
        chunk = int(tot / nr_cores) + 1
        batch, cur = [], 0
        for info in lst:
            cur += math.pow(len(info[3]), 2)
            batch.append(info)
            if cur >= chunk:
                yield batch
                batch, cur = [], 0
        yield batch
    else:
        # the reference silently yields nothing for unknown batch types and
        # crashes downstream (parallelize.py:33-81 has no else; its help text
        # advertises "weighted" which no branch implements) — fail loudly.
        raise ValueError(f"unknown batch_type: {batch_type!r}")


def _print_intermediate(clusters: Dict[int, List[str]], store: ReadStore,
                        cfg: Config, iter_nr: int) -> None:
    """Per-iteration dumps (reference parallelize.py:85-104)."""
    path = os.path.join(cfg.outfolder, str(iter_nr))
    mkdir_p(path)
    with open(os.path.join(path, "pre_clusters.csv"), "w") as out:
        for c_id, accs in sorted(clusters.items(), key=lambda x: len(x[1]), reverse=True):
            for acc in accs:
                out.write("{0}\t{1}\n".format(c_id, "_".join(acc.split("_")[:-1])))
    with open(os.path.join(path, "cluster_origins.csv"), "w") as out:
        for c_id, accs in sorted(clusters.items(), key=lambda x: len(x[1]), reverse=True):
            r = store.row(c_id)
            out.write("{0}\t{1}\t{2}\t{3}\t{4}\t{5}\n".format(
                c_id, store.accs[r], store.seqs[r], store.quals[r],
                float(store.scores[r]), float(store.error_rates[r]),
            ))


def merge_tree_clustering(
    store: ReadStore,
    read_array: Sequence[ReadTuple],
    gap_table: GapPassTable,
    cfg: Config,
) -> Tuple[Dict[int, List[str]], List[int]]:
    """Full merge-tree schedule; returns (clusters, surviving rep ids)."""
    num_batches = cfg.nr_cores
    read_batches = list(batch_list(read_array, num_batches, batch_type=cfg.batch_type))
    logger.debug("Nr reads in batches: %s", [len(b) for b in read_batches])

    all_clusters: Dict[int, List[str]] = {r[0]: [r[2]] for r in read_array}
    carried_dbs: List[MinimizerDB] = [MinimizerDB() for _ in read_batches]
    it = 1
    while True:
        logger.debug("ITERATION %d with %d batches", it, len(read_batches))
        if len(read_batches) == 1:
            batch = read_batches[0]
            rows = np.array([store.row(r[0]) for r in batch], dtype=np.int64)
            skip_idx = max(1, min((r[1] for r in batch), default=1))
            clusters = {r[0]: all_clusters[r[0]] for r in batch}
            clusters, alive, _ = reads_to_clusters(
                store, clusters, rows, gap_table, cfg,
                carried_db=carried_dbs[0], skip_batch_index=skip_idx,
                new_batch_index=1,
            )
            return clusters, alive

        batch_results = []
        dbs: Dict[int, MinimizerDB] = {}
        for bi, batch in enumerate(read_batches):
            rows = np.array([store.row(r[0]) for r in batch], dtype=np.int64)
            skip_idx = max(1, min((r[1] for r in batch), default=1))
            clusters = {r[0]: all_clusters[r[0]] for r in batch}
            clusters, alive, db = reads_to_clusters(
                store, clusters, rows, gap_table, cfg,
                carried_db=carried_dbs[bi], skip_batch_index=skip_idx,
                new_batch_index=bi + 1,
            )
            # preserve the original within-batch order of survivors so the
            # stable score re-sort ties break like the reference's dict merge
            alive_set = set(alive)
            ordered_alive = [r[0] for r in batch if r[0] in alive_set]
            batch_results.append((clusters, ordered_alive))
            dbs[bi + 1] = db

        for clusters, _ in batch_results:
            all_clusters.update(clusters)
        surviving: List[int] = []
        for _, ordered_alive in batch_results:
            surviving.extend(ordered_alive)
        # representatives re-sorted by score, stable (parallelize.py:184)
        surviving.sort(key=lambda rid: -store.scores[store.row(rid)])
        read_array = [
            (rid, int(store.batch_indices[store.row(rid)]), store.accs[store.row(rid)],
             store.seq_b[store.row(rid)], store.qual_b[store.row(rid)],
             float(store.scores[store.row(rid)]))
            for rid in surviving
        ]
        logger.debug("number of representatives left to cluster: %d", len(read_array))
        pruned = {rid: all_clusters[rid] for rid in surviving}
        _print_intermediate(pruned, store, cfg, it)
        all_clusters = pruned

        it += 1
        read_batches = [
            b for b in batch_list(read_array, merge_consecutive=True) if b
        ]
        carried_dbs = []
        for batch in read_batches:
            lowest = min(r[1] for r in batch)
            carried_dbs.append(dbs[lowest])
