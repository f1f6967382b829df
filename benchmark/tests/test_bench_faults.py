"""The check calls a run wrong when the timed path is wrong.

Each test drives a whole run of a tiny cell on the CPU (the kernels' plain
PyTorch versions; the harness's look for a card skipped) with the timed
path broken underneath by one of ``faults.py``'s entries, and sees
``correct`` come out false, through the number that entry breaks.  A sound
run of the same cell comes out true.  On the chip, ``run.py --control NAME``
makes the same runs at a cell's own size.
"""

import pytest

from benchmark import run
from benchmark.faults import CONTROLS, FAULTS

from helpers import quiet, tiny_root

#: The number each entry has to fail.
BREAKS = {
    "no_fallback": "cluster_bad",
    "aligned_half": "cluster_bad",
    "rep_consensus": "consensus_err",
    "stats_altered": "stats_bad",
    "stats_half": "stats_bad",
    "moves_altered": "moves_bad",
    "decision_altered": "cluster_bad",
    "sorted_altered": "sorted_bad",
    "consensus_altered": "consensus_err",
    "half_consensus": "consensus_missing",
}
SEED = 2**31 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def run_tiny(root, control=""):
    return run.run_cell("tiny.medaka", SEED, 0.1, False, root=root,
                        control=control, backend="torch",
                        require_chip=False, log=quiet)


def test_a_sound_run_is_correct(root):
    result = run_tiny(root)
    assert result["correct"] is True, result["checks"]
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("name", sorted({**CONTROLS, **FAULTS}))
def test_each_control_and_fault_is_called_wrong(root, name):
    result = run_tiny(root, control=name)
    assert result["correct"] is False
    broken = result["checks"][BREAKS[name]]
    assert broken["value"] > broken["limit"], result["checks"]
