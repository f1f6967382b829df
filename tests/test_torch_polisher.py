"""The port's GRU polisher (ngspeciesid_tpu_torch.models.polisher) against
the JAX package.

The in-repo weights (``data/polisher_gru.npz``) go through the carry-over
``params_from_jax`` into ``nn.GRU``; its logits must equal JAX ``forward``
within atol 1e-4 (the two frameworks sum float32 products in different
orders: 4.8e-6 was measured at L=300 padded to 512), with the argmax equal
everywhere.  Everything downstream of the logits is exact: the port's
``neural_polish_round`` and a ``--medaka_model <npz>`` CLI run on the CPU
(NGSID_STATS_BACKEND=torch) must give byte-equal output to the JAX
package's.
"""

import os

import numpy as np
import pytest
import torch

from ngspeciesid_tpu import cli as ref_cli
from ngspeciesid_tpu.models import polisher as ref
from ngspeciesid_tpu.models.train import ACGT, load_params as ref_load, mutate
from ngspeciesid_tpu_torch import cli as port_cli
from ngspeciesid_tpu_torch.config import Config
from ngspeciesid_tpu_torch.consensus import stage as port_stage
from ngspeciesid_tpu_torch.device import polisher_device
from ngspeciesid_tpu_torch.models import polisher as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "ngspeciesid_tpu_torch", "data", "polisher_gru.npz")
REF_MODEL = os.path.join(REPO, "ngspeciesid_tpu", "data", "polisher_gru.npz")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def torch_backend(monkeypatch):
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")


def test_weights_file_is_the_jax_packages():
    with open(MODEL, "rb") as a, open(REF_MODEL, "rb") as b:
        assert a.read() == b.read()


def test_logits_match_jax_forward(rng):
    with np.load(MODEL) as data:
        state = port.params_from_jax({k: data[k] for k in data.files})
    model = port.GRUPolisher()
    model.load_state_dict(state)
    assert not model.gru.bias_hh_l0.any() and not model.gru.bias_hh_l0_reverse.any()
    feats = np.zeros((1, 512, port.N_FEATURES), np.float32)
    feats[0, :300] = rng.random((300, port.N_FEATURES), dtype=np.float32)
    feats[0, :300, 11:15] = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 300)]
    want = np.asarray(ref._forward_jit(ref_load(REF_MODEL), feats))
    got = port.forward_logits(model.eval(), feats)
    assert got.shape == want.shape == (1, 512, port.N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def _draft_errors(rng, t):
    """A draft with a substitution, a deletion and an insertion."""
    draft = t.copy()
    draft[60] = ACGT[(int(np.where(ACGT == draft[60])[0][0]) + 1) % 4]
    draft = np.delete(draft, 150)
    return np.insert(draft, 250, ACGT[0])


@pytest.mark.parametrize("case", ["draft_errors", "heldout"])
def test_neural_polish_round_equal_to_jax(rng, case):
    """The fixtures of tests/test_neural_polisher.py."""
    if case == "draft_errors":
        t = ACGT[rng.integers(0, 4, size=400)]
        reads, quals = zip(*(mutate(rng, t, 0.08) for _ in range(30)))
        draft = _draft_errors(rng, t)
    else:
        t = ACGT[rng.integers(0, 4, size=350)]
        reads, quals = zip(*(mutate(rng, t, 0.10) for _ in range(25)))
        draft, _ = mutate(rng, t, 0.02)
    want = ref.neural_polish_round(ref_load(REF_MODEL), draft, list(reads),
                                   list(quals))
    port.FORWARDS.clear()
    got = port.neural_polish_round(port.load_params(MODEL, CPU), draft,
                                   list(reads), list(quals))
    assert got.dtype == np.uint8
    assert got.tobytes() == want.tobytes()
    assert port.FORWARDS == {"cpu": 1}


def _files(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


def test_cli_medaka_model_byte_equal_to_jax(tmp_path, rng, monkeypatch):
    """The CLI fixture of tests/test_neural_polisher.py, both packages."""
    template = "".join("ACGT"[c] for c in rng.integers(0, 4, size=300))
    fq = tmp_path / "in.fastq"
    with open(fq, "w") as f:
        for i in range(30):
            seq = "".join(ch for ch in template if rng.random() > 0.03)
            qual = "".join(chr(int(q)) for q in rng.integers(45, 63, size=len(seq)))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    args = ["--ont", "--fastq", str(fq), "--consensus", "--medaka", "--t", "1"]
    monkeypatch.delenv("NGSID_STATS_BACKEND")
    assert ref_cli.main(args + ["--medaka_model", REF_MODEL, "--outfolder",
                                str(tmp_path / "ref")]) == 0
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    port.FORWARDS.clear()
    assert port_cli.main(args + ["--medaka_model", MODEL, "--outfolder",
                                 str(tmp_path / "port")]) == 0
    want = _files(tmp_path / "ref")
    got = _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name
    polished = [n for n in got if n.endswith("consensus.fasta")]
    assert len(polished) == 1
    assert port.FORWARDS == {"cpu": len(polished)}


def _broken(flat, kind):
    flat = dict(flat)
    if kind == "missing":
        del flat["bwd/wh"]
    elif kind == "shape":
        flat["fwd/b"] = flat["fwd/b"][:-1]
    elif kind == "extra":
        flat["fwd/bh"] = flat["fwd/b"]
    return flat


@pytest.mark.parametrize("kind", ["missing", "shape", "extra"])
def test_malformed_params_raise_before_polishing(tmp_path, kind):
    with np.load(MODEL) as data:
        flat = _broken({k: data[k] for k in data.files}, kind)
    with pytest.raises(ValueError, match="GRU params"):
        port.params_from_jax(flat)
    path = tmp_path / "bad.npz"
    np.savez(path, **flat)
    out = tmp_path / "out"
    out.mkdir()
    cfg = Config(outfolder=str(out), medaka=True, medaka_model=str(path))
    centers = [[3, 0, "ACGT" * 20, [str(tmp_path / "missing_reads.fq")]]]
    with pytest.raises(ValueError, match="GRU params"):
        port_stage.polish_sequences(centers, cfg)
    assert not list(out.iterdir())


def test_gru_device_follows_the_backend(monkeypatch):
    for backend in ("torch", "native", "host"):
        assert polisher_device(backend) == CPU
    monkeypatch.setenv("NGSID_STATS_BACKEND", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_stage._load_neural_polisher(MODEL)
