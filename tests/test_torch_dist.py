"""The port's distributed clustering (ngspeciesid_tpu_torch.parallel.dist)
against its merge tree and the JAX package, on the CPU.

NGSID_STATS_BACKEND=torch: the stats kernel's plain PyTorch version.  Ranks
run as threads over GlooWorld (every exchange a gloo all-gather), each with
its own ReadStore as hosts have, and as two OS processes of the port's CLI
with NGSID_DISTRIBUTED=1, started as a launcher starts them.  Every rank's
result must equal the port's merge tree at nr_cores = ranks and the JAX
package's distributed_clustering over its ThreadWorld; the CLI's stage-3
files must be byte-equal to the JAX package's CLI at --t 2.
"""

import os
import subprocess
import sys
import tempfile
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import ngspeciesid_tpu.cli as ref_cli
import ngspeciesid_tpu.cluster.engine as ref_engine
import ngspeciesid_tpu.cluster.store as ref_store
import ngspeciesid_tpu.config as ref_config
import ngspeciesid_tpu.parallel.dist as ref_dist
import ngspeciesid_tpu.parallel.merge as ref_merge
import ngspeciesid_tpu.utils.ptable as ref_ptable
import ngspeciesid_tpu_torch.cluster.engine as port_engine
import ngspeciesid_tpu_torch.cluster.store as port_store
import ngspeciesid_tpu_torch.config as port_config
import ngspeciesid_tpu_torch.parallel.dist as port_dist
import ngspeciesid_tpu_torch.parallel.merge as port_merge
import ngspeciesid_tpu_torch.utils.ptable as port_ptable

from .test_cluster_engine import simulate_reads, to_read_array

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Template length of the thread-rank pools: the plain DP costs a Python
#: step per anti-diagonal, and rank threads take turns at the interpreter.
TLEN = 250
OUTPUTS = ("sorted.fastq", "final_clusters.tsv", "final_cluster_origins.tsv")
PORT = SimpleNamespace(engine=port_engine, store=port_store,
                       config=port_config, dist=port_dist, merge=port_merge,
                       ptable=port_ptable)
REF = SimpleNamespace(engine=ref_engine, store=ref_store, config=ref_config,
                      dist=ref_dist, merge=ref_merge, ptable=ref_ptable)


@pytest.fixture(autouse=True)
def plain_backend(monkeypatch):
    """The stats kernel's plain version, one intra-op thread (the ranks are
    threads themselves, and the suite runs several workers at once)."""
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(pkg, read_array, cfg):
    store = pkg.store.build_store(read_array, cfg.k, cfg.w)
    p_matrix = pkg.ptable.p_table_as_matrix(
        pkg.ptable.load_p_table(cfg.k, cfg.w))
    max_gap = max((c.size for c in store.min_codes), default=1)
    return store, pkg.engine.GapPassTable(p_matrix, cfg.min_prob_no_hits,
                                          max_gap)


def _merge_tree(read_array, n):
    cfg = PORT.config.Config(nr_cores=n, outfolder=tempfile.mkdtemp())
    store, gap_table = _inputs(PORT, read_array, cfg)
    return PORT.merge.merge_tree_clustering(store, read_array, gap_table, cfg)


def _distributed(pkg, world, read_array, n):
    """Every rank's result, each rank on its own store (hosts do not share
    memory)."""
    def rank_run(rank):
        cfg = pkg.config.Config(nr_cores=n, outfolder=None)
        store, gap_table = _inputs(pkg, read_array, cfg)
        return pkg.dist.distributed_clustering(
            store, read_array, gap_table, cfg, world.comm(rank),
            write_intermediate=False)

    if isinstance(world, port_dist.GlooWorld):
        return world.run(rank_run)
    results = [None] * n
    errors = []

    def worker(rank):
        try:
            results[rank] = rank_run(rank)
        except BaseException as e:  # surfaced below
            errors.append(e)
            world._barrier.abort()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


@pytest.mark.parametrize("case", ["shards", "empty"])
def test_codec_matches_reference(rng, case):
    results = {}
    if case == "shards":
        for si in sorted(rng.choice(9, size=5, replace=False).tolist()):
            ids = rng.integers(0, 1000, size=int(rng.integers(0, 6))).tolist()
            clusters = {rid: [rid] + rng.integers(0, 1000, size=int(
                rng.integers(0, 4))).tolist() for rid in ids}
            results[si] = (clusters, ids)
    flat = port_dist._encode_results(results)
    assert flat.dtype == np.int64
    assert np.array_equal(flat, ref_dist._encode_results(results))
    assert port_dist._decode_results(flat) == results


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_gloo_world_matches_merge_tree_and_reference(rng, n_ranks):
    read_array = to_read_array(simulate_reads(rng, n_templates=3,
                                              reads_per=14, tlen=TLEN,
                                              err=0.08))
    want = _merge_tree(read_array, n_ranks)
    ref = _distributed(REF, REF.dist.ThreadWorld(n_ranks), read_array,
                       n_ranks)
    port_dist.reset_counts()
    got = _distributed(PORT, port_dist.GlooWorld(n_ranks), read_array,
                       n_ranks)
    for r in range(n_ranks):
        assert got[r] == want
        assert got[r] == ref[r]
    # every rank's exchanges went through TorchComm
    assert port_dist.TRAFFIC["exchanges"] > 0
    assert port_dist.TRAFFIC["exchanges"] % n_ranks == 0


def test_replicated_across_ranks(rng):
    read_array = to_read_array(simulate_reads(rng, n_templates=2,
                                              reads_per=10, tlen=TLEN,
                                              err=0.1))
    got = _distributed(PORT, port_dist.GlooWorld(3), read_array, 3)
    for r in got[1:]:
        assert r == got[0]


def test_more_ranks_than_shards(rng):
    # 5 reads on 4 ranks: idle ranks still join every exchange and agree
    read_array = to_read_array(simulate_reads(rng, n_templates=1,
                                              reads_per=5, tlen=TLEN))
    want = _merge_tree(read_array, 4)
    for got in _distributed(PORT, port_dist.GlooWorld(4), read_array, 4):
        assert got == want


def test_localcomm_equals_merge_tree(rng):
    read_array = to_read_array(simulate_reads(rng, n_templates=2,
                                              reads_per=8, tlen=TLEN))
    cfg = PORT.config.Config(nr_cores=1, outfolder=None)
    store, gap_table = _inputs(PORT, read_array, cfg)
    got = port_dist.distributed_clustering(
        store, read_array, gap_table, cfg, port_dist.LocalComm(),
        write_intermediate=False)
    assert got == _merge_tree(read_array, 1)


def test_launcher_comm_without_a_world_is_local(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with port_dist.launcher_comm() as comm:
        assert isinstance(comm, port_dist.LocalComm)
    assert not torch.distributed.is_initialized()


def test_two_process_cli_matches_reference_t2(tmp_path, monkeypatch):
    """Two OS processes of ``python -m ngspeciesid_tpu_torch`` with
    NGSID_DISTRIBUTED=1, started as torchrun starts them (spawn_local: the
    repository root on PYTHONPATH, a free port), one outfolder each."""
    pool = str(tmp_path / "pool.fastq")
    subprocess.run(
        [sys.executable, os.path.join("scripts", "simulate_reads.py"),
         "--out", pool, "--n_reads", "240", "--n_species", "3",
         "--length", "300", "--error", "0.07", "--seed", "3"],
        check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
    ref_out = str(tmp_path / "ref")
    assert ref_cli.main(["--ont", "--fastq", pool, "--t", "2",
                         "--outfolder", ref_out]) == 0

    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(NGSID_DISTRIBUTED="1", NGSID_STATS_BACKEND="torch",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"rank{r}") for r in range(2)]
    logs = port_dist.spawn_local(
        [[sys.executable, "-m", "ngspeciesid_tpu_torch", "--ont", "--fastq",
          pool, "--outfolder", out] for out in outs],
        timeout_s=240, env=env, cwd=str(tmp_path))
    for r, (_, err) in enumerate(logs):
        assert f"rank {r} of 2" in err, err[-2000:]
    for name in OUTPUTS:
        with open(os.path.join(ref_out, name), "rb") as f:
            want = f.read()
        assert want, name
        for out in outs:
            with open(os.path.join(out, name), "rb") as f:
                assert f.read() == want, (out, name)
