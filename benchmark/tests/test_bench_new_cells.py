"""The cells ``rdna_community.medaka`` and ``coi_plate.gru`` on the CPU.

A tiny copy of ``rdna_community`` (one 2,100-base core, above the windowed
polish's 2 kb gate, and 100 reads; ``data/tiny_rdna.json``) runs through
the harness with the kernels' plain versions: a sound run is ``correct``,
and the readers of ``window_map_share`` and ``window_map_us_per_read`` read
its libraries' records; the ``rep_consensus`` control, the one of
``faults.py`` that touches the long centres, is called wrong on it (the
clustering controls are judged on the tiny plate by
``test_bench_faults.py``).  The run is not traced: on the CPU the profiler
records every op of the plain DPs, tens of GB at 2 kb.  A traced run of
the tiny plate under the ``gru`` traffic reports ``gru_share`` in its
result.  The file takes ~10 min on one CPU worker: the plain DPs at 2 kb.
"""

import json
import os
import shutil

import pytest
import torch

from benchmark import run

from helpers import HERE, ROOT, quiet, tiny_root

SEED = 2**31 + 21


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain DPs run many small ops per diagonal, which extra intra-op
    threads only slow down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rdna_root(tmp_path_factory):
    """A root whose cell ``tiny.medaka`` runs the tiny rDNA library."""
    root = tiny_root(tmp_path_factory.mktemp("rdna"))
    shutil.copy(os.path.join(HERE, "data", "tiny_rdna.json"),
                os.path.join(root, "benchmark", "configs", "tiny.json"))
    return root


def run_tiny(root, trace, control="", cell="tiny.medaka"):
    return run.run_cell(cell, SEED, 0.1, trace, root=root, control=control,
                        backend="torch", require_chip=False, log=quiet)


def test_a_long_amplicon_run_is_correct_and_reads_the_window_metrics(
        rdna_root):
    lines = []
    result = run.run_cell("tiny.medaka", SEED, 0.1, False, root=rdna_root,
                          backend="torch", require_chip=False,
                          log=lambda *a, **k: lines.append(a[0]))
    assert result["correct"] is True, result["checks"]
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    json.dumps(result)
    logged = [json.loads(x) for x in lines if x.startswith('{"libraries"')]
    libs = [run.Lib(d["index"], d["reads"], "", "", None, d["wall"],
                    d["walls"]) for d in logged[0]["libraries"]]
    rec = run.Records("tiny.medaka", 0.0, sum(lib.wall for lib in libs),
                      libs, [], {})
    bench = run.Bench(rdna_root)
    wanted = {m["name"]: m for m in bench.metrics("tiny.medaka", True)}
    assert {"window_map_share", "window_map_us_per_read"} <= set(wanted)
    share = bench.reader("window_map_share")(rec)
    assert 0 < share < 100 and wanted["window_map_share"]["unit"] == "%"
    assert bench.reader("window_map_us_per_read")(rec) > 0
    assert wanted["window_map_us_per_read"]["unit"] == "us"
    # every polished centre is over 2 kb: each polished read was mapped
    assert all(lib.walls["poa.window_reads"] == lib.walls["poa.reads"] > 0
               for lib in libs)
    assert bench.reader("gru_share")(rec) is None


def test_the_consensus_control_is_called_wrong_on_long_amplicons(rdna_root):
    result = run_tiny(rdna_root, False, control="rep_consensus")
    assert result["correct"] is False
    broken = result["checks"]["consensus_err"]
    assert broken["value"] > broken["limit"], result["checks"]


def test_a_gru_run_of_the_tiny_plate_reads_gru_share(tmp_path, monkeypatch):
    # the traffic names the weights from the checkout's root, where the
    # benchmark's command runs
    monkeypatch.chdir(ROOT)
    root = tiny_root(tmp_path, traffic="gru")
    result = run_tiny(root, True, cell="tiny.gru")
    assert result["correct"] is True, result["checks"]
    got = result["metrics"]
    assert 0 < got["gru_share"]["value"] < 100
    assert got["gru_share"]["unit"] == "%"
    assert not {"window_map_share", "window_map_us_per_read"} & set(got)
