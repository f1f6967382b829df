"""Stages 1-3 of the port against the JAX package, end to end on the CPU.

A seeded multi-species pool goes through ``ngspeciesid_tpu_torch.cli.main``
with NGSID_STATS_BACKEND=torch (the stats kernel's plain PyTorch version)
and through ``ngspeciesid_tpu.cli.main`` with its CPU default (the native
engine).  sorted.fastq, final_clusters.tsv and final_cluster_origins.tsv
must be byte-equal, single pass (--t 1) and merge tree (--t 2); and every
file must be byte-equal under --resume (whose second run hits the cache),
--use_old_sorted_file, --isoseq and the write_fastq subcommand.
"""

import json
import os
import shutil
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


def _files(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


@pytest.fixture(scope="module")
def ref_run(pool, tmp_path_factory):
    """The JAX package's stages 1-3 on the pool, with its CPU default."""
    out = str(tmp_path_factory.mktemp("ref_run") / "out")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NGSID_STATS_BACKEND", raising=False)
        assert ref_cli.main(["--ont", "--fastq", pool, "--outfolder", out]) == 0
    return out


def _manifest(folder):
    """The --resume cache's stage keys and file names (the paths it
    records are the run's own)."""
    with open(os.path.join(folder, ".ngsid_cache", "manifest.json")) as f:
        return {stage: (entry["key"], [os.path.basename(p)
                                       for p in entry["files"]])
                for stage, entry in json.load(f).items()}


@pytest.mark.parametrize("case", ["resume", "use_old_sorted_file", "isoseq",
                                  "write_fastq"])
def test_cli_path_byte_equal_to_reference(pool, ref_run, tmp_path,
                                          monkeypatch, case):
    folders = {who: str(tmp_path / who) for who in ("ref", "port")}
    if case == "write_fastq":
        def argv(who):
            return ["write_fastq", "--clusters",
                    os.path.join(ref_run, "final_clusters.tsv"), "--fastq",
                    pool, "--outfolder", folders[who], "--N", "5"]
    elif case == "use_old_sorted_file":
        # stage 1 reads <outfolder>/sorted.fastq, never --fastq
        for folder in folders.values():
            os.makedirs(folder)
            shutil.copy(os.path.join(ref_run, "sorted.fastq"), folder)

        def argv(who):
            return ["--ont", "--use_old_sorted_file", "--outfolder",
                    folders[who]]
    else:
        preset = "--isoseq" if case == "isoseq" else "--ont"
        extra = ["--resume"] if case == "resume" else []

        def argv(who):
            return [preset, "--fastq", pool, *extra, "--outfolder",
                    folders[who]]
    monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
    assert ref_cli.main(argv("ref")) == 0
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    assert port_cli.main(argv("port")) == 0
    first = _files(folders["port"])
    if case == "resume":
        assert _manifest(folders["port"]) == _manifest(folders["ref"])
        assert set(_manifest(folders["port"])) == {"sort", "cluster"}
        align_stats.reset_counts()
        assert port_cli.main(argv("port")) == 0
        assert align_stats.PLAIN_PAIRS == 0     # the cache answered
        assert _files(folders["port"]) == first
    want = _files(folders["ref"])
    if case == "resume":
        del want[os.path.join(".ngsid_cache", "manifest.json")]
        del first[os.path.join(".ngsid_cache", "manifest.json")]
    assert sorted(first) == sorted(want)
    if case == "write_fastq":
        assert len(want) >= 5 and all(want.values())
    else:
        assert all(want[name] for name in OUTPUTS)
    for name, data in want.items():
        assert first[name] == data, name


def test_bad_window_exits_1(pool, tmp_path, monkeypatch):
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    assert port_cli.main(["--fastq", pool, "--k", "30", "--w", "20",
                          "--outfolder", str(tmp_path / "o")]) == 1


def test_medaka_model_help_is_the_references():
    def helps(parser):
        return {a.dest: a.help for a in parser._actions}
    want = helps(ref_cli.build_parser())["medaka_model"]
    assert helps(port_cli.build_parser())["medaka_model"] == want
    assert "a PATH loads trained GRU params" in want
