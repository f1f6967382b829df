"""The port's offline evaluation tools against the JAX package's, on the
CPU: the cluster-quality metrics (``eval``), the BAM reader (``io/bam``),
the cluster-quality CLI (``quality``, scripts/compute_cluster_quality.py in
the JAX package), the shared-minimizer table generator
(``generate_p_table``) and the polisher grid (``eval_polisher``).

``eval``, ``io/bam``, ``quality`` and ``generate_p_table`` are copies, so
their results must be equal, float for float and byte for byte.  The
polisher grid runs the port's alignments in the moves kernel's plain
PyTorch version (NGSID_STATS_BACKEND=torch) and the GRU on the CPU; its
mean edit distances must equal the reference script's.
"""

import csv
import gzip
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ngspeciesid_tpu import eval as ref_eval
from ngspeciesid_tpu.io import bam as ref_bam
from ngspeciesid_tpu_torch import eval as port_eval
from ngspeciesid_tpu_torch import eval_polisher
from ngspeciesid_tpu_torch.io import bam as port_bam
from ngspeciesid_tpu_torch.models import polisher

from .test_bam import bam_path  # noqa: F401  (the in-test BAM fixture)
from .test_torch_polisher import MODEL, REF_MODEL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _labelings(rng):
    """test_eval.py's labelings: 20 random ones, then the perfect one."""
    out = []
    for _ in range(20):
        n = int(rng.integers(5, 200))
        out.append((rng.integers(0, 6, size=n).tolist(),
                    rng.integers(0, 8, size=n).tolist()))
    lt = [0, 0, 1, 1, 2]
    return out + [(lt, lt)]


def test_metrics_equal_to_reference(rng):
    for lt, lp in _labelings(rng):
        assert (port_eval.homogeneity_completeness_v(lt, lp)
                == ref_eval.homogeneity_completeness_v(lt, lp))
        assert (port_eval.adjusted_rand_index(lt, lp)
                == ref_eval.adjusted_rand_index(lt, lp))
        assert (port_eval.cluster_size_stats(np.bincount(lp).tolist())
                == ref_eval.cluster_size_stats(np.bincount(lp).tolist()))


def test_helpers_and_evaluate_equal_to_reference(rng):
    classes = {"a": 0, "b": 0, "c": 1}
    clusters = {"a": 5, "b": 5}
    assert (port_eval.with_singleton_fill(classes, clusters)
            == ref_eval.with_singleton_fill(classes, clusters))
    assert (port_eval.cluster_size_stats([50, 30, 20])
            == ref_eval.cluster_size_stats([50, 30, 20]))
    classes = {f"r{i}": int(c) for i, c in
               enumerate(rng.integers(0, 5, size=120))}
    classes.update({"x": 9})
    clusters = {f"r{i}": int(c) for i, c in
                enumerate(rng.integers(0, 7, size=100))}
    for min_size in (0, 5):
        assert (port_eval.evaluate(classes, clusters, min_size)
                == ref_eval.evaluate(classes, clusters, min_size))


def test_bam_reader_equal_to_reference(bam_path, tmp_path):  # noqa: F811
    assert list(port_bam.read_bam(bam_path)) == list(ref_bam.read_bam(bam_path))
    for fn in ("classes_from_ref_names", "classes_from_intervals"):
        got = getattr(port_bam, fn)(bam_path)
        assert got == getattr(ref_bam, fn)(bam_path) and got, fn
    bad = tmp_path / "bad.bam"
    bad.write_bytes(gzip.compress(b"notabam"))
    with pytest.raises(ValueError, match="magic"):
        list(port_bam.read_bam(str(bad)))
    assert (port_bam.FLAG_SECONDARY, port_bam.FLAG_SUPPLEMENTARY,
            port_bam.FLAG_UNMAPPED) == (ref_bam.FLAG_SECONDARY,
                                        ref_bam.FLAG_SUPPLEMENTARY,
                                        ref_bam.FLAG_UNMAPPED)


def _run(args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("truth", ["tsv", "bam", "bam_simulated"])
def test_quality_cli_writes_the_reference_csv(bam_path, tmp_path,  # noqa: F811
                                              truth):
    """final_clusters.tsv rows (cluster, accession) over the BAM's reads and
    two the truth does not name."""
    clusters = tmp_path / "final_clusters.tsv"
    clusters.write_text("".join(
        f"{c}\t{acc} extra\n" for c, acc in
        ((0, "r1"), (0, "r2"), (1, "r3"), (1, "r4"), (2, "u1"), (2, "u2"))))
    if truth == "tsv":
        classes = tmp_path / "truth.tsv"
        classes.write_text("r1\tsp1\nr2\tsp1\nr3\tsp2\nr4\tsp1\nr9\tsp3\n")
        extra = ["--classes", str(classes), "--min_class_size", "2"]
    else:
        extra = ["--classes_bam", bam_path]
        if truth == "bam_simulated":
            extra.append("--simulated")
    outs = {}
    for who, entry in (("ref", [os.path.join("scripts",
                                             "compute_cluster_quality.py")]),
                       ("port", ["-m", "ngspeciesid_tpu_torch.quality"])):
        out = tmp_path / f"{who}.csv"
        stdout = _run([*entry, "--clusters", str(clusters), *extra,
                       "--outfile", str(out)])
        outs[who] = (out.read_bytes(), stdout)
    assert outs["port"] == outs["ref"]
    with open(tmp_path / "port.csv") as f:
        row = next(csv.DictReader(f))
    assert 0.0 <= float(row["v_measure"]) <= 1.0


def test_generate_p_table_equal_to_reference(tmp_path):
    args = ["--k_min", "10", "--k_max", "11", "--replicates", "2",
            "--template_len", "300", "--errors", "0.05,0.10", "--seed", "3"]
    _run([os.path.join("scripts", "generate_p_table.py"),
          "--out", str(tmp_path / "ref.npz"), *args])
    _run(["-m", "ngspeciesid_tpu_torch.generate_p_table",
          "--out", str(tmp_path / "port.npz"), *args])
    with np.load(tmp_path / "ref.npz") as ref, \
            np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(ref.files) == [
            "e1", "e2", "k", "p", "w"]
        for key in ref.files:
            assert got[key].dtype == ref[key].dtype
            assert np.array_equal(got[key], ref[key]), key
        # 3 error pairs x (19 windows at k 10 + 18 at k 11)
        assert got["p"].size == 3 * (19 + 18) and got["p"].max() > 0


def _reference_script(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_polisher_grid_equal_to_reference(monkeypatch):
    """One template of 200 bp per cell."""
    ref = _reference_script("eval_polisher")
    want = ref.run_grid(ref.load_params(REF_MODEL), n_templates=1, tlen=200)
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    polisher.FORWARDS.clear()
    try:
        got = eval_polisher.run_grid(
            polisher.load_params(MODEL, torch.device("cpu")), n_templates=1,
            tlen=200)
    finally:
        torch.set_num_threads(threads)
    assert got == want
    assert len(got) == 9 and polisher.FORWARDS == {"cpu": 9}
