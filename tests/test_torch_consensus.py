"""Stage 4 of the port against the JAX package, end to end on the CPU.

A seeded pool (3 species, universal tails at both ends, 7% error, both
orientations) goes through ``ngspeciesid_tpu_torch.cli.main`` with
NGSID_STATS_BACKEND=torch (the kernels' plain PyTorch versions) and through
``ngspeciesid_tpu.cli.main`` with its CPU default (the native engine).
Every output file must be byte-equal for the medaka-class, racon-class and
universal-tail runs.  The stage's modules (pileup, draft POA, polish round,
RC merge) are held bit-equal on seeded inputs too.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ngspeciesid_tpu import cli as ref_cli
from ngspeciesid_tpu.consensus import stage as ref_stage
from ngspeciesid_tpu.ops import poa as ref_poa
from ngspeciesid_tpu_torch import cli as port_cli
from ngspeciesid_tpu_torch.consensus import stage as port_stage
from ngspeciesid_tpu_torch.ops import align_moves, align_stats
from ngspeciesid_tpu_torch.ops import poa as port_poa
from ngspeciesid_tpu_torch.utils.seqs import (
    bytes_to_str,
    reverse_complement,
    reverse_complement_bytes,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the universal tails of consensus/stage.get_universal_tails
TAIL_F = "TTTCTGTTGGTGCTGATATTGC"
TAIL_R = "ACTTGCCTGTCGCTCTATCTTC"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain DPs run many small ops per diagonal, which extra intra-op
    threads only slow down (and the suite runs several workers at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """240 reads of 3 species, 250 bp between the two universal tails."""
    d = tmp_path_factory.mktemp("pool")
    tails = d / "tails.fa"
    tails.write_text(f">1_F\n{TAIL_F}\n>2_R\n{reverse_complement(TAIL_R)}\n")
    path = str(d / "pool.fastq")
    subprocess.run(
        [sys.executable, "-m", "ngspeciesid_tpu_torch.simulate", "--out",
         path, "--n_reads", "240", "--n_species", "3", "--length", "250",
         "--error", "0.07", "--seed", "2", "--primer_file", str(tails)],
        check=True, cwd=REPO, stdout=subprocess.DEVNULL)
    return path


def _files(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


@pytest.mark.parametrize("extra, polished", [
    (["--medaka"], "medaka_cl_id_*/consensus.fasta"),
    (["--racon", "--racon_iter", "2"], "racon_cl_id_*/mapping_it_1.paf"),
    (["--medaka", "--remove_universal_tails"], "medaka_cl_id_*/consensus.fasta"),
    (["--medaka", "--primer_file", "{tails}"], "medaka_cl_id_*/consensus.fasta"),
], ids=["medaka", "racon", "tails", "primer_file"])
def test_stage4_outputs_byte_equal_to_reference(pool, tmp_path, monkeypatch,
                                                extra, polished):
    """``{tails}``: the pool's tails file, given as --primer_file."""
    tails = os.path.join(os.path.dirname(pool), "tails.fa")
    args = ["--ont", "--fastq", pool, "--t", "1", "--consensus",
            "--abundance_ratio", "0.05", *(a.format(tails=tails) for a in extra)]
    monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
    assert ref_cli.main(args + ["--outfolder", str(tmp_path / "ref")]) == 0

    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    align_moves.reset_counts()
    align_stats.reset_counts()
    assert port_cli.main(args + ["--outfolder", str(tmp_path / "port")]) == 0
    assert align_moves.PLAIN_PAIRS > 0 and align_stats.PLAIN_PAIRS > 0
    assert align_moves.LAUNCHES == 0 and align_stats.LAUNCHES == 0

    want = _files(tmp_path / "ref")
    got = _files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        assert got[name] == data, name
    # every species became a polished center
    assert len(list((tmp_path / "port").glob(polished))) == 3
    cons = [got[n] for n in got if n.startswith("consensus_reference_")]
    assert all(len(c) > 200 for c in cons)
    if "--remove_universal_tails" in extra or "--primer_file" in extra:
        assert not any(TAIL_F.encode() in c for c in cons)


def _noisy_reads(rng, center, n):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    reads, quals = [], []
    for _ in range(n):
        keep = rng.random(center.size) >= 0.03
        r = center[keep].copy()
        sub = rng.random(r.size) < 0.03
        r[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
        ins = np.flatnonzero(rng.random(r.size) < 0.03)
        r = np.insert(r, ins, acgt[rng.integers(0, 4, ins.size)])
        reads.append(r.astype(np.uint8))
        quals.append(rng.integers(40, 70, size=r.size).astype(np.uint8))
    return reads, quals


class TestModules:
    @pytest.fixture(autouse=True)
    def backends(self, monkeypatch):
        monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
        monkeypatch.delenv("NGSID_PILEUP", raising=False)

    def test_pileup_stats_bit_equal(self, rng):
        center = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 260)]
        reads, quals = _noisy_reads(rng, center, 14)
        reads.append(reverse_complement_bytes(reads[0]))   # junk orientation
        quals.append(quals[0][::-1])
        want = ref_poa.pileup_stats(center, reads, quals)
        got = port_poa.pileup_stats(center, reads, quals)
        for field in ("votes", "qvotes", "coverage", "ins_open"):
            assert np.array_equal(getattr(got, field), getattr(want, field))
        assert got.ins_votes == want.ins_votes

    def test_msa_consensus_batch_bit_equal(self, rng):
        acgt = np.frombuffer(b"ACGT", np.uint8)
        clusters = []
        for n in (7, 12, 3):
            template = acgt[rng.integers(0, 4, int(rng.integers(180, 240)))]
            clusters.append(_noisy_reads(rng, template, n)[0])
        want = ref_poa.msa_consensus_batch(clusters, max_reads=10)
        got = port_poa.msa_consensus_batch(clusters, max_reads=10)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]

    def test_polish_round_bit_equal(self, rng):
        center = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 240)]
        reads, quals = _noisy_reads(rng, center, 16)
        draft = _noisy_reads(rng, center, 1)[0][0]
        for q in (quals, None):
            want = ref_poa.polish_round(draft, reads, q)
            got = port_poa.polish_round(draft, reads, q)
            assert got.tolist() == want.tolist()

    def test_rc_merge_equal_and_consumes_every_identity(self, rng, monkeypatch):
        acgt = np.frombuffer(b"ACGT", np.uint8)
        a, b, c = (acgt[rng.integers(0, 4, 200)] for _ in range(3))
        near = [a, reverse_complement_bytes(_noisy_reads(rng, a, 1)[0][0]),
                b, _noisy_reads(rng, a, 1)[0][0], c,
                reverse_complement_bytes(b), _noisy_reads(rng, b, 1)[0][0]]
        centers = [[10 - i, i, bytes_to_str(s), f"reads_{i}.fq"]
                   for i, s in enumerate(near)]
        # blocks of 2 outers: outer 1 is absorbed by outer 0 after their
        # block's identities exist, the case whose entries used to linger
        monkeypatch.setattr(port_stage, "_RC_BLOCK", 2)
        monkeypatch.setattr(ref_stage, "_RC_BLOCK", 2)
        monkeypatch.delenv("NGSID_STATS_BACKEND")
        want = ref_stage.detect_reverse_complements(
            [list(x) for x in centers], 0.8)
        monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
        got = port_stage.detect_reverse_complements(
            [list(x) for x in centers], 0.8)
        assert got == want
        assert len(got) == 3


def test_medaka_model_name_and_params_file(monkeypatch):
    from ngspeciesid_tpu_torch.models.polisher import (
        GRUPolisher, neural_polish_round)

    assert port_stage._load_neural_polisher("") is None
    assert port_stage._load_neural_polisher("r941_min_high_g360") is None
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    params = os.path.join(REPO, "ngspeciesid_tpu_torch", "data",
                          "polisher_gru.npz")
    model, fn = port_stage._load_neural_polisher(params)
    assert isinstance(model, GRUPolisher) and fn is neural_polish_round
    assert next(model.parameters()).device == torch.device("cpu")
    with pytest.raises(ValueError):
        port_stage._load_neural_polisher("not a model")


def test_simulator_copy_writes_the_same_pool(tmp_path):
    outs = []
    for name, cmd in (("ref", [os.path.join("scripts", "simulate_reads.py")]),
                      ("port", ["-m", "ngspeciesid_tpu_torch.simulate"])):
        out = tmp_path / f"{name}.fastq"
        subprocess.run(
            [sys.executable, *cmd, "--out", str(out), "--n_reads", "500",
             "--n_species", "4", "--length", "300", "--seed", "11"],
            check=True, cwd=REPO, stdout=subprocess.DEVNULL)
        outs.append(out.read_bytes())
    assert outs[0] and outs[0] == outs[1]
