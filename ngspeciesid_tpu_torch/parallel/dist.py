"""Multi-process distributed clustering over torch.distributed collectives.

Port of ngspeciesid_tpu/parallel/dist.py.  The reference's parallel
clustering is single-host multiprocessing with pickled dict merges
(reference modules/parallelize.py:107-217).  This module runs the same
hierarchical merge-tree topology across *processes* (on one host or many):
every rank reads the shared sorted fastq, takes ownership of a subset of
shards, runs the wave-batched engine on them, and exchanges per-round
results through all-gather collectives over a gloo process group instead of
pipes.

Design properties that make the exchange cheap and the result replicated:

  * Every rank holds the full score-sorted read array (shared filesystem —
    the reference makes the same assumption for its worker processes), so
    the collective payload is only int64 ids: surviving representative ids
    plus (rep id, member ids) cluster postings.  Sequences never move.
  * A shard's minimizer database is exactly the minimizers of its surviving
    representatives (the engine only inserts codes when a read *becomes* a
    representative, reference cluster.py:329-334, and never deletes), so a
    new owner rebuilds the carried DB locally from survivor ids instead of
    shipping postings.
  * The merge bookkeeping (survivor re-sort, consecutive shard pairing,
    carried-DB selection — reference parallelize.py:184-215) is
    deterministic, so every rank replays it identically and the final
    clustering is replicated on all ranks without a broadcast; the last
    single-shard pass (reference parallelize.py:142-149) runs replicated.

Determinism across placements: decisions depend only on the frozen DB
snapshot and the total-order candidate key (hits, sum positions, accession
rank — reference cluster.py:79), never on posting order, so rebuild order
is free and the distributed result equals the single-host merge tree
(differential-tested in tests/test_torch_dist.py).

Transports: :class:`TorchComm` over a torch.distributed group (the ranks of
a launcher such as ``torchrun``, see :func:`launcher_comm` and
:func:`spawn_local`), :class:`GlooWorld` (ranks as threads of one process,
every exchange a real gloo all-gather), :class:`ThreadWorld` (threads
swapping slots in shared memory) and :class:`LocalComm` (one rank).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..cluster.engine import GapPassTable, MinimizerDB, reads_to_clusters
from ..cluster.store import ReadStore
from .merge import batch_list, _print_intermediate

logger = logging.getLogger(__name__)

ReadTuple = Tuple[int, int, str, str, str, float]

#: TorchComm's exchanges in this process and their payload bytes: sent (this
#: rank's), received (every rank's, its own included) and the largest sent.
TRAFFIC = {"exchanges": 0, "sent_bytes": 0, "recv_bytes": 0,
           "max_payload_bytes": 0}
_TRAFFIC_LOCK = threading.Lock()


def reset_counts() -> None:
    with _TRAFFIC_LOCK:
        for key in TRAFFIC:
            TRAFFIC[key] = 0


# ---------------------------------------------------------------------------
# communication backends
# ---------------------------------------------------------------------------

class TorchComm:
    """Collective exchange over a torch.distributed process group (default:
    the default group), whose ranks are processes on one host or many.

    Variable-length int64 all-gather as two fixed-shape collectives: gather
    sizes, pad to the max, gather data.  The payload is int64 read ids that
    live on the host, so the group is a gloo group over CPU tensors, on a
    GPU machine too: NCCL cannot put two ranks on one GPU, and moving host
    ids to a device only to reach NCCL would add two copies an exchange.
    Every exchange is counted into :data:`TRAFFIC`."""

    def __init__(self, group=None) -> None:
        import torch.distributed as dist

        self.group = dist.group.WORLD if group is None else group
        self.rank = self.group.rank()
        self.size = self.group.size()

    def allgather_i64(self, arr: np.ndarray) -> List[np.ndarray]:
        import torch
        import torch.distributed as dist

        arr = np.ascontiguousarray(arr, dtype=np.int64)
        size = torch.tensor([arr.size], dtype=torch.int64)
        sizes = [torch.empty_like(size) for _ in range(self.size)]
        dist.all_gather(sizes, size, group=self.group)
        sizes = torch.cat(sizes).numpy()
        mx = max(1, int(sizes.max()))
        pad = torch.zeros(mx, dtype=torch.int64)
        pad[: arr.size] = torch.from_numpy(arr)
        data = [torch.empty_like(pad) for _ in range(self.size)]
        dist.all_gather(data, pad, group=self.group)
        with _TRAFFIC_LOCK:
            TRAFFIC["exchanges"] += 1
            TRAFFIC["sent_bytes"] += arr.nbytes
            TRAFFIC["recv_bytes"] += int(sizes.sum()) * 8
            TRAFFIC["max_payload_bytes"] = max(TRAFFIC["max_payload_bytes"],
                                               arr.nbytes)
        return [data[p][: int(sizes[p])].numpy().copy()
                for p in range(self.size)]

    def barrier(self, name: str) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)


class GlooWorld:
    """P-rank world in one process whose every exchange is a gloo
    all-gather: one ``ProcessGroupGloo`` per rank, each rank a thread, the
    groups formed through one in-memory store.  Unlike ThreadWorld, no rank
    ever reads another rank's buffer from shared memory: all data moves
    through gloo's transport, as between processes (the counterpart of the
    reference's DeviceWorld, an XLA all-gather over a local mesh)."""

    def __init__(self, size: int, timeout_s: float = 300.0) -> None:
        from torch.distributed import HashStore

        self.size = size
        self._store = HashStore()
        self._timeout = datetime.timedelta(seconds=timeout_s)
        self._formed: Dict[Tuple[int, str], int] = {}
        self._lock = threading.Lock()

    def group(self, rank: int, members: Optional[Sequence[int]] = None,
              name: str = "world"):
        """Rank ``rank``'s gloo group over ``members`` (default: every
        rank).  Every member's thread calls it with the same name and
        members, in the same order as its other calls; it returns once all
        have joined."""
        from torch.distributed import PrefixStore, ProcessGroupGloo

        members = list(range(self.size)) if members is None else list(members)
        with self._lock:
            nth = self._formed.get((rank, name), 0)
            self._formed[(rank, name)] = nth + 1
        return ProcessGroupGloo(PrefixStore(f"{name}/{nth}/", self._store),
                                members.index(rank), len(members),
                                self._timeout)

    def comm(self, rank: int) -> TorchComm:
        return TorchComm(self.group(rank))

    def run(self, fn) -> list:
        """``fn(rank)`` on one thread per rank; the results in rank order.
        Raises the first rank's error as soon as it is raised (ranks left
        waiting in a collective are daemon threads, which the groups'
        timeout ends)."""
        results: list = [None] * self.size
        errors: List[BaseException] = []

        def worker(rank: int) -> None:
            try:
                results[rank] = fn(rank)
            except BaseException as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            while t.is_alive() and not errors:
                t.join(0.05)
            if errors:
                raise errors[0]
        return results


class ThreadWorld:
    """In-process P-rank world for tests: one thread per rank, barrier-
    synchronised slot exchange.  Exercises the exact driver code path the
    multi-host deployment runs; only the transport differs."""

    def __init__(self, size: int) -> None:
        self.size = size
        self._barrier = threading.Barrier(size)
        self._slots: List[Optional[np.ndarray]] = [None] * size

    def comm(self, rank: int) -> "ThreadComm":
        return ThreadComm(self, rank)


class ThreadComm:
    def __init__(self, world: ThreadWorld, rank: int) -> None:
        self._world = world
        self.rank = rank
        self.size = world.size

    def allgather_i64(self, arr: np.ndarray) -> List[np.ndarray]:
        w = self._world
        w._slots[self.rank] = np.ascontiguousarray(arr, dtype=np.int64)
        w._barrier.wait()
        out = [w._slots[p].copy() for p in range(w.size)]
        w._barrier.wait()  # all ranks read before the next round overwrites
        return out

    def barrier(self, name: str) -> None:
        self._world._barrier.wait()


class LocalComm:
    """Single-rank comm: the distributed driver degenerates to the
    single-host merge tree."""

    rank = 0
    size = 1

    def allgather_i64(self, arr: np.ndarray) -> List[np.ndarray]:
        return [np.ascontiguousarray(arr, dtype=np.int64)]

    def barrier(self, name: str) -> None:
        pass


# ---------------------------------------------------------------------------
# payload codec: per-round shard results as one flat int64 array
# ---------------------------------------------------------------------------

def _encode_results(
    results: Dict[int, Tuple[Dict[int, List[int]], List[int]]]
) -> np.ndarray:
    out: List[int] = [len(results)]
    for si in sorted(results):
        clusters, alive = results[si]
        out.append(si)
        out.append(len(alive))
        out.extend(alive)
        out.append(len(clusters))
        for rid, members in clusters.items():
            out.append(rid)
            out.append(len(members))
            out.extend(members)
    return np.asarray(out, dtype=np.int64)


def _decode_results(
    flat: np.ndarray,
) -> Dict[int, Tuple[Dict[int, List[int]], List[int]]]:
    flat = flat.tolist()
    pos = 0

    def take(n: int) -> List[int]:
        nonlocal pos
        out = flat[pos : pos + n]
        pos += n
        return out

    results: Dict[int, Tuple[Dict[int, List[int]], List[int]]] = {}
    (n_shards,) = take(1)
    for _ in range(n_shards):
        si, n_alive = take(2)
        alive = take(n_alive)
        (n_clusters,) = take(1)
        clusters: Dict[int, List[int]] = {}
        for _ in range(n_clusters):
            rid, n_members = take(2)
            clusters[rid] = take(n_members)
        results[si] = (clusters, alive)
    return results


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _rebuild_db(store: ReadStore, alive_ids: Sequence[int], k: int) -> MinimizerDB:
    """Carried DB of a shard == minimizers of its surviving representatives
    (insertion-only invariant of the engine; see module docstring)."""
    db = MinimizerDB()
    for rid in alive_ids:
        row = store.id_to_row[int(rid)]
        if store.hpol[row].size >= k:
            db.insert(store.min_codes[row], int(rid))
    return db


def _run_shard(
    store: ReadStore,
    batch: Sequence[ReadTuple],
    all_clusters: Dict[int, List[int]],
    carried_alive: Sequence[int],
    gap_table: GapPassTable,
    cfg: Config,
    new_batch_index: int,
) -> Tuple[Dict[int, List[int]], List[int]]:
    rows = np.array([store.row(r[0]) for r in batch], dtype=np.int64)
    skip_idx = max(1, min((r[1] for r in batch), default=1))
    clusters = {r[0]: all_clusters[r[0]] for r in batch}
    clusters, alive, _ = reads_to_clusters(
        store, clusters, rows, gap_table, cfg,
        carried_db=_rebuild_db(store, carried_alive, cfg.k),
        skip_batch_index=skip_idx,
        new_batch_index=new_batch_index,
    )
    return clusters, alive


def distributed_clustering(
    store: ReadStore,
    read_array: Sequence[ReadTuple],
    gap_table: GapPassTable,
    cfg: Config,
    comm,
    write_intermediate: bool = True,
) -> Tuple[Dict[int, List[str]], List[int]]:
    """Merge-tree clustering with shards owned by ranks; returns the
    replicated (clusters, surviving rep ids) on every rank.  Cluster values
    are accession lists, as in parallel/merge.py."""
    P = comm.size
    # round 1 keeps empty shards so batch-index numbering matches the
    # single-host merge tree exactly (merge rounds filter them, as it does)
    shards = list(batch_list(read_array, P, batch_type=cfg.batch_type))
    # members tracked as read ids; converted to accessions at the end
    all_clusters: Dict[int, List[int]] = {r[0]: [r[0]] for r in read_array}
    # carried-DB source: batch index -> surviving rep ids of that shard
    alive_by_batch: Dict[int, List[int]] = {}
    it = 1
    while True:
        logger.debug("DIST ITERATION %d with %d shards on %d ranks",
                     it, len(shards), P)
        if len(shards) == 1:
            # final pass runs replicated on every rank (deterministic), like
            # the reference's in-process finish (parallelize.py:142-149)
            batch = shards[0]
            lowest = min((r[1] for r in batch), default=0)
            clusters, alive = _run_shard(
                store, batch, all_clusters,
                alive_by_batch.get(lowest, []), gap_table, cfg,
                new_batch_index=1,
            )
            final = {
                rid: [store.accs[store.row(m)] for m in members]
                for rid, members in clusters.items()
            }
            return final, alive

        # --- owned shards run locally
        owned: Dict[int, Tuple[Dict[int, List[int]], List[int]]] = {}
        for si, batch in enumerate(shards):
            if si % P != comm.rank:
                continue
            lowest = min((r[1] for r in batch), default=0) if it > 1 else -1
            owned[si] = _run_shard(
                store, batch, all_clusters,
                alive_by_batch.get(lowest, []), gap_table, cfg,
                new_batch_index=si + 1,
            )

        # --- exchange: every rank learns every shard's result
        gathered = comm.allgather_i64(_encode_results(owned))
        results: Dict[int, Tuple[Dict[int, List[int]], List[int]]] = {}
        for payload in gathered:
            results.update(_decode_results(payload))

        # --- replicated merge bookkeeping (reference parallelize.py:168-215)
        for si in range(len(shards)):
            clusters, _ = results[si]
            all_clusters.update(clusters)
            # every read of the pass carries the shard's batch index now
            rows = np.array([store.row(r[0]) for r in shards[si]], dtype=np.int64)
            store.batch_indices[rows] = si + 1
        surviving: List[int] = []
        for si in range(len(shards)):
            surviving.extend(results[si][1])
        surviving.sort(key=lambda rid: -store.scores[store.row(rid)])
        read_array = [
            (rid, int(store.batch_indices[store.row(rid)]),
             store.accs[store.row(rid)], store.seq_b[store.row(rid)],
             store.qual_b[store.row(rid)], float(store.scores[store.row(rid)]))
            for rid in surviving
        ]
        pruned = {rid: all_clusters[rid] for rid in surviving}
        all_clusters = pruned
        alive_by_batch = {si + 1: results[si][1] for si in range(len(shards))}

        if write_intermediate and comm.rank == 0 and cfg.outfolder:
            acc_view = {
                rid: [store.accs[store.row(m)] for m in members]
                for rid, members in pruned.items()
            }
            _print_intermediate(acc_view, store, cfg, it)
        comm.barrier(f"dist-clustering-it{it}")

        it += 1
        shards = [
            b for b in batch_list(read_array, merge_consecutive=True) if b
        ]


# ---------------------------------------------------------------------------
# launcher ranks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def launcher_comm():
    """The comm of this process's rank: a TorchComm over the default group
    when the world has more than one rank (``WORLD_SIZE`` in the
    environment, or an already-initialised default group), else LocalComm.
    A default group that is not initialised yet is initialised from the
    launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) with the gloo backend, and destroyed on exit.  Logs
    the rank's exchanges and payload bytes on exit."""
    import torch.distributed as dist

    created = False
    if dist.is_initialized():
        multi = dist.get_world_size() > 1
    else:
        multi = int(os.environ.get("WORLD_SIZE", "1")) > 1
        if multi:
            dist.init_process_group("gloo")
            created = True
    comm = TorchComm() if multi else LocalComm()
    before = dict(TRAFFIC)
    try:
        yield comm
    finally:
        if multi:
            logger.info(
                "Distributed clustering: rank %d of %d, %d exchanges, "
                "%d bytes sent, %d bytes received", comm.rank, comm.size,
                *(TRAFFIC[k] - before[k]
                  for k in ("exchanges", "sent_bytes", "recv_bytes")))
        if created:
            dist.destroy_process_group()


def spawn_local(argvs: Sequence[Sequence[str]], timeout_s: float,
                env: Optional[Dict[str, str]] = None,
                cwd: Optional[str] = None) -> List[Tuple[str, str]]:
    """Run one process per argv as the ranks of one world on this host, as
    ``torchrun`` starts them: ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` (127.0.0.1) and ``MASTER_PORT`` (a
    free port) in each one's environment (``env``, default this process's),
    and the repository root first on ``PYTHONPATH``: Python puts a script's
    own directory, not the working directory, at the head of ``sys.path``.
    Returns each rank's standard output and error output.  Raises RuntimeError with a rank's
    error output when it exits non-zero or the ranks outlast ``timeout_s``;
    every rank still running then is killed."""
    import socket
    import subprocess
    import tempfile
    import time

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = dict(os.environ if env is None else env)
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, base.get("PYTHONPATH", "")) if p)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    n = len(argvs)
    procs = []
    try:
        for rank, argv in enumerate(argvs):
            rank_env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank),
                            WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            procs.append((subprocess.Popen(list(argv), env=rank_env, cwd=cwd,
                                           stdout=out, stderr=err), out, err))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [proc.poll() for proc, _, _ in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                rank = failed[0]
                err = procs[rank][2]
                err.seek(0)
                tail = err.read().decode(errors="replace")[-4000:]
                raise RuntimeError(
                    f"rank {rank} of {n} exited {codes[rank]}:\n{tail}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"ranks still running after {timeout_s} s")
            time.sleep(0.05)
        outs = []
        for _, out, err in procs:
            out.seek(0)
            err.seek(0)
            outs.append((out.read().decode(errors="replace"),
                         err.read().decode(errors="replace")))
        return outs
    finally:
        for proc, out, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
