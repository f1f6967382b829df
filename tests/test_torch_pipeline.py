"""Stages 1-3 of the port against the JAX package, end to end on the CPU.

A seeded multi-species pool goes through ``ngspeciesid_tpu_torch.cli.main``
with NGSID_STATS_BACKEND=torch (the stats kernel's plain PyTorch version)
and through ``ngspeciesid_tpu.cli.main`` with its CPU default (the native
engine).  sorted.fastq, final_clusters.tsv and final_cluster_origins.tsv
must be byte-equal, single pass (--t 1) and merge tree (--t 2).
"""

import os
import subprocess
import sys

import pytest
import torch

from ngspeciesid_tpu import cli as ref_cli
from ngspeciesid_tpu_torch import cli as port_cli
from ngspeciesid_tpu_torch.ops import align_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("sorted.fastq", "final_clusters.tsv", "final_cluster_origins.tsv")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain DP runs many small ops per diagonal, which extra intra-op
    threads only slow down (and the suite runs several workers at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """600 reads of 4 species, ~300 bp, 7% error, both orientations."""
    path = str(tmp_path_factory.mktemp("pool") / "pool.fastq")
    subprocess.run(
        [sys.executable, os.path.join("scripts", "simulate_reads.py"),
         "--out", path, "--n_reads", "600", "--n_species", "4",
         "--length", "300", "--error", "0.07", "--seed", "1"],
        check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    return path


def _read(folder, name):
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("shards", [1, 2])
def test_outputs_byte_equal_to_reference(pool, tmp_path, monkeypatch, shards):
    args = ["--ont", "--fastq", pool, "--t", str(shards)]
    monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
    assert ref_cli.main(args + ["--outfolder", str(tmp_path / "ref")]) == 0

    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    align_stats.reset_counts()
    assert port_cli.main(args + ["--outfolder", str(tmp_path / "port")]) == 0
    assert align_stats.PLAIN_PAIRS > 0
    assert align_stats.LAUNCHES == 0

    for name in OUTPUTS:
        want = _read(tmp_path / "ref", name)
        assert want, name
        assert _read(tmp_path / "port", name) == want, name


@pytest.mark.parametrize("env, extra", [({"NGSID_DISTRIBUTED": "1"}, [])])
def test_unported_paths_exit_1(pool, tmp_path, monkeypatch, env, extra):
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    out = tmp_path / "out"
    assert port_cli.main(["--ont", "--fastq", pool, "--outfolder", str(out)]
                         + extra) == 1
    assert not out.exists()


def test_bad_window_exits_1(pool, tmp_path, monkeypatch):
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    assert port_cli.main(["--fastq", pool, "--k", "30", "--w", "20",
                          "--outfolder", str(tmp_path / "o")]) == 1
