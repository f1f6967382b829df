"""The port never imports JAX or the JAX package, and never runs device
work on the CPU unasked.

The runtime checks run in a subprocess: tests/conftest.py imports jax into
this process for the whole session.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ngspeciesid_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def tiny_pool(tmp_path_factory):
    """40 reads of two species, 200 bp, written by numpy from a seed."""
    import numpy as np

    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    lines = []
    for sp in range(2):
        template = acgt[rng.integers(0, 4, size=200)]
        for r in range(20):
            seq = template[rng.random(template.size) > 0.05].tobytes().decode()
            lines += [f"@read{sp}_{r}", seq, "+", "5" * len(seq)]
    path = tmp_path_factory.mktemp("tiny") / "tiny.fastq"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _run(args, backend, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["NGSID_STATS_BACKEND"] = backend
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cpu_cli_run_imports_no_jax(tiny_pool, tmp_path):
    out = tmp_path / "out"
    code = (
        "import sys\n"
        "import ngspeciesid_tpu_torch\n"
        "from ngspeciesid_tpu_torch import cli\n"
        f"rc = cli.main(['--ont', '--fastq', {tiny_pool!r}, '--t', '2',\n"
        f"               '--consensus', '--medaka',\n"
        f"               '--abundance_ratio', '0.2',\n"
        f"               '--outfolder', {str(out)!r}])\n"
        "assert rc == 0, rc\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'flax', 'optax')))\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules if m == 'ngspeciesid_tpu' or "
        "m.startswith('ngspeciesid_tpu.'))\n"
        "assert not ref, ref\n"
        "print('NO_JAX_OK')\n")
    proc = _run(["-c", code], "torch")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert (out / "final_clusters.tsv").stat().st_size > 0
    assert list(out.glob("medaka_cl_id_*/consensus.fasta"))


def test_cuda_backend_without_gpu_fails_loudly(tiny_pool, tmp_path):
    out = tmp_path / "out"
    proc = _run(["-m", "ngspeciesid_tpu_torch", "--ont", "--fastq", tiny_pool,
                 "--outfolder", str(out)], "cuda")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    # it stopped before stage 1: nothing ran on the CPU instead
    assert not (out / "sorted.fastq").exists()


def test_no_port_source_names_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    # the JAX package itself, even its JAX-free modules, and its scripts
    reference = re.compile(
        r"^\s*(import|from)\s+ngspeciesid_tpu(?!_torch)\b"
        r"|[\"']scripts[\"'/\\]", re.M)
    sources = [SMOKE]
    for root, _, files in os.walk(PORT):
        sources += [os.path.join(root, n) for n in files if n.endswith(".py")]
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not pattern.search(text), path
        assert not reference.search(text), path
