"""The harness: the trace arithmetic, the module check, finding files by
name, and the shape of the result line."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark import trace as tr

from helpers import ROOT, quiet, tiny_root

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_idle_share_is_a_union_not_a_sum():
    # two overlapping kernels and one inside the other: busy 0-4 and 6-7
    device = [("a", 0.0, 3.0), ("b", 1.0, 4.0), ("c", 2.0, 2.5),
              ("d", 6.0, 7.0), ("outside", 20.0, 30.0)]
    t = tr.Trace(window=tr.union([(0.0, 5.0), (5.0, 10.0)]), device=device)
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(5.0)
    summed = sum(min(b, 10.0) - a for _, a, b in device[:4])
    assert summed == pytest.approx(7.5)          # what a sum would claim
    assert tr.gaps(t.busy(), t.window) == [(4.0, 6.0), (7.0, 10.0)]
    assert t.kernel_seconds("a") == pytest.approx(3.0)
    assert t.top_ops()[0] == ["a", pytest.approx(3.0)]


def test_idle_gaps_are_split_by_the_innermost_host_range():
    t = tr.Trace(window=[(0.0, 10.0)], device=[("k", 0.0, 1.0), ("k", 5.0, 6.0)],
                 host=[("stage23.cluster", 0.5, 9.0),
                       ("cluster.conflict", 1.0, 4.0)])
    idle = dict((name, s) for name, s in t.idle_by_layer())
    assert idle["cluster.conflict"] == pytest.approx(3.0)     # 1-4
    assert idle["stage23.cluster"] == pytest.approx(4.0)      # 4-5, 6-9
    assert idle["library"] == pytest.approx(1.0)              # 9-10
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)


def test_chrome_trace_reading(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "library", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "stage1.sort", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "wavefront_kernel<StatsK, 2>", "ts": 200, "dur": 300},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 400, "dur": 200},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "library", "ts": 200, "dur": 400},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 10, "dur": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = tr.from_chrome(str(path))
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(400e-6)
    assert t.kernel_seconds("StatsK") == pytest.approx(300e-6)


@pytest.mark.parametrize("names,found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "os"], ["jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["ngspeciesid_tpu"], ["ngspeciesid_tpu"]),
    (["ngspeciesid_tpu.ops.align"], ["ngspeciesid_tpu.ops.align"]),
    (["ngspeciesid_tpu_torch", "ngspeciesid_tpu_torch.cli"], []),
    (["jaxtyping", "numpy"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert run.forbidden_modules(names) == found


def test_files_are_found_by_name(tmp_path):
    reader = ("def read(rec):\n"
              "    return float(sum(lib.reads for lib in rec.libraries))\n")
    root = tiny_root(tmp_path, metric_files=[("test_reads_seen", reader)])
    bench = run.Bench(root)
    assert bench.cell("tiny.medaka")["config"] == "tiny"
    assert bench.config("tiny")["library"]["reads"] == 120
    assert bench.traffic("medaka")["stage_flags"] == ["--consensus", "--medaka"]
    rec = run.Records("tiny.medaka", 1.0, 2.0,
                      [run.Lib(0, 120, "", "", None)], [], {})
    assert bench.reader("test_reads_seen")(rec) == 120.0
    assert bench.reader("reads_per_s")(rec) == 60.0
    assert "test_reads_seen" in [m["name"] for m in bench.metrics("tiny.medaka", True)]
    with pytest.raises(run.NoResult):
        bench.cell("no.such")
    with pytest.raises(run.NoResult):
        bench.reader("no_such_metric")


def test_a_new_cell_and_metric_run_without_editing_a_file(tmp_path):
    """A cell, a configuration and a metric added as new files only: a
    whole run on the CPU finds them, and its result has the contract's keys
    in order, then ``checks``."""
    reader = ("def read(rec):\n"
              "    return float(sum(lib.reads for lib in rec.libraries))\n")
    root = tiny_root(tmp_path, traffic="cluster",
                     metric_files=[("test_reads_seen", reader)],
                     stage_flags=[])
    result = run.run_cell("tiny.cluster", 2**31 + 11, 0.1, False, root=root,
                          backend="torch", require_chip=False, log=quiet)
    assert list(result) == CONTRACT_KEYS + ["checks"]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"reads_per_s", "sample_p90_s", "setup_s"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_without_a_card_the_run_prints_no_result(tmp_path):
    """The benchmark's command, in a directory that holds only
    BENCHMARK.json and the benchmark's files: no result, a non-zero exit."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "coi_plate.medaka",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no result" in proc.stderr


def test_a_traced_run_reports_the_per_layer_metrics(tmp_path):
    """``--trace 1`` on the CPU: the per-layer metrics that read host
    records are there, the throwaway metric too, and the device metrics,
    which have no device to read, are left out."""
    reader = ("def read(rec):\n"
              "    return float(len(rec.libraries))\n")
    root = tiny_root(tmp_path, metric_files=[("test_libraries", reader)])
    result = run.run_cell("tiny.medaka", 2**31 + 12, 0.1, True, root=root,
                          backend="torch", require_chip=False, log=quiet)
    assert result["correct"] is True, result["checks"]
    got = set(result["metrics"])
    assert {"sort_share", "cluster_share", "conflict_share", "consensus_share",
            "polish_share", "test_libraries"} <= got
    assert not got & {"stats_kernel_roofline", "moves_kernel_roofline",
                      "device_idle_share", "reads_per_s", "setup_s"}
    assert list(result)[-2:] == ["breakdown", "checks"]
    for share in ("sort_share", "cluster_share", "consensus_share"):
        assert 0 < result["metrics"][share]["value"] < 100


@pytest.mark.chip
def test_a_cell_runs_correct_on_the_card():
    """On a machine with a card: a short run of the smallest cell prints a
    correct result line."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the chip")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "coi_plate.medaka",
         "--seed", str(2**31 + 5), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(result)[:5] == CONTRACT_KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"

