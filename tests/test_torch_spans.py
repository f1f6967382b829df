"""The port's spans (ngspeciesid_tpu_torch/spans.py): what they add to the
sink, under threads and nesting, when they reach the profiler's timeline,
and what a CLI run's ``stage_walls`` receives from them."""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from ngspeciesid_tpu_torch import cli, spans
from ngspeciesid_tpu_torch.cluster import engine
from ngspeciesid_tpu_torch.config import Config
from ngspeciesid_tpu_torch.consensus import stage

#: The older keys of ``stage_walls`` and the spans that fill them.
STAGE_KEYS = {"sort": "stage1.sort", "cluster": "stage23.cluster",
              "consensus_polish": "stage4", "stage4_draft": "stage4.draft",
              "stage4_trim": "stage4.trim", "stage4_rc": "stage4.rc",
              "stage4_polish": "stage4.polish"}
#: Every span a --t 2 --consensus --medaka run opens below its stages.
INNER = ("run.load", "cluster.build", "cluster.decide", "cluster.align",
         "cluster.conflict", "merge.dump", "poa.fold", "polish.files",
         "poa.orient", "poa.walk", "poa.call", "moves.stage", "moves.wait",
         "moves.reconstruct", "stats.stage", "stats.wait", "stats.gather")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain DP runs many small ops per diagonal, which extra intra-op
    threads only slow down (and the suite runs several workers at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reads(rng, n_species, n_reads, length, error):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for sp in range(n_species):
        template = acgt[rng.integers(0, 4, size=length)]
        for r in range(n_reads):
            seq = template[rng.random(template.size) > error]
            out.append((f"read{sp}_{r}", seq.tobytes().decode()))
    return out


def test_a_span_adds_its_seconds_and_a_count_adds_to_the_sink():
    walls = {}
    with spans.sink(walls):
        with spans.span("a") as first:
            pass
        with spans.span("a") as second:
            pass
        spans.count("n")
        spans.count("n", 4)
    assert first.seconds > 0 and second.seconds > 0
    assert walls["a"] == first.seconds + second.seconds
    assert walls["n"] == 5
    with spans.span("a") as outside:      # no sink: timed, not recorded
        pass
    spans.count("n")
    assert outside.seconds > 0
    assert walls == {"a": first.seconds + second.seconds, "n": 5}


def test_a_nested_sink_restores_the_one_before():
    outer, inner = {}, {}
    with spans.sink(outer):
        spans.count("x")
        with spans.sink(inner):
            spans.count("x", 2)
        spans.count("x", 3)
    spans.count("x", 100)
    assert outer == {"x": 4}
    assert inner == {"x": 2}


def test_the_spans_of_many_threads_all_count():
    """More threads than cores, switching often: a lost update would leave
    the count short."""
    walls = {}
    n_threads = (os.cpu_count() or 1) + 1
    rounds = 10000
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(rounds):
            with spans.span("t"):
                spans.count("n")
            spans.count("n")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.sink(walls):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert walls["n"] == 2 * rounds * n_threads
    assert walls["t"] > 0


def test_without_a_recording_profiler_no_range_is_opened(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    walls = {}
    with spans.sink(walls), spans.span("poa.walk"):
        pass
    assert "poa.walk" in walls


def test_a_profiled_stage_4_holds_the_spans_as_annotations(tmp_path,
                                                            monkeypatch):
    """Stage 4 of three 48 bp reads under torch.profiler (CPU activity):
    the exported chrome trace holds the spans as user annotations."""
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    rng = np.random.default_rng(3)
    reads = _reads(rng, 1, 3, 48, 0.02)
    sorted_fastq = tmp_path / "sorted.fastq"
    sorted_fastq.write_text("".join(f"@{acc}_1.0\n{seq}\n+\n{'5' * len(seq)}\n"
                                    for acc, seq in reads))
    (tmp_path / "work").mkdir()
    cfg = Config(consensus=True, medaka=True, outfolder=str(tmp_path))
    cfg.apply_preset(ont=True)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        centers = stage.run_consensus_stage(
            {0: [f"{acc}_1.0" for acc, _ in reads]}, {0: 1.0},
            str(sorted_fastq), str(tmp_path / "work"), 1, cfg)
    assert len(centers) == 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"poa.walk", "moves.stage", "stage4.polish"} <= names


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """40 reads of two species, 200 bp, written by numpy from a seed."""
    reads = _reads(np.random.default_rng(7), 2, 20, 200, 0.05)
    path = tmp_path_factory.mktemp("pool") / "pool.fastq"
    path.write_text("".join(f"@{acc}\n{seq}\n+\n{'5' * len(seq)}\n"
                            for acc, seq in reads))
    return str(path)


def test_a_cli_run_fills_every_span_and_the_older_keys(pool, tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    engine.reset_perf_counters()
    walls = {}
    rc = cli.main(["--ont", "--fastq", pool, "--t", "2", "--consensus",
                   "--medaka", "--abundance_ratio", "0.2",
                   "--outfolder", str(tmp_path / "out")], stage_walls=walls)
    assert rc == 0
    assert list((tmp_path / "out").glob("medaka_cl_id_*/consensus.fasta"))
    for key, name in STAGE_KEYS.items():
        assert walls[key] == walls.get(name, 0.0), key
    assert "stage4.trim" not in walls             # no primer file
    assert walls["stage4_trim"] == 0.0
    for key, name in (("decide_s", "cluster.decide"),
                      ("align_s", "cluster.align"),
                      ("conflict_s", "cluster.conflict")):
        assert engine.PERF_COUNTERS[key] == walls[name]
    for name in INNER:
        assert walls[name] > 0, name
    assert walls["poa.reads"] > 0
    inside = sum(walls[n] for n in ("poa.orient", "poa.walk", "poa.call",
                                    "polish.files"))
    assert inside <= walls["stage4.polish"]
    assert sum(walls[f"stage4.{p}"] for p in ("draft", "rc", "polish")
               ) <= walls["stage4"]
    assert not os.path.exists(tmp_path / "out" / "profile")
