"""The port's driver entry points (ngspeciesid_tpu_torch.graft_entry)
against the JAX package's polisher, on the CPU.

- ``entry()``'s forward on the JAX ``init_params(PRNGKey(0))`` weights,
  carried over by ``params_from_jax``, within atol 1e-5 of JAX ``forward``.
- ``dryrun_multichip(8)``: data 2 x model 4 gloo rank threads at hidden
  128.  Its train step is held inside the dry run against the port's
  single-device ``make_train_step``: the loss within LOSS_RTOL = 1e-6
  relative, every gradient gathered from the shards within GRAD_ATOL = 1e-6,
  and Adam on the same gradients within ADAM_ATOL = 1e-7 (7e-8, 9e-9 and 0
  were measured on the CPU).  Its loss and gradients are also held against
  ``jax.value_and_grad(loss_fn)`` on the same weights and batch, as
  tests/test_torch_train.py holds the single-device step.  Its clustering
  over 8 rank threads and over 2 processes equals the merge tree (the dry
  run raises otherwise).

NGSID_STATS_BACKEND=torch: the clustering's alignments run in the stats
kernel's plain PyTorch version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ngspeciesid_tpu.models import polisher as ref
from ngspeciesid_tpu_torch import graft_entry
from ngspeciesid_tpu_torch.models import polisher as port

from .test_torch_train import _flat

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def torch_backend(monkeypatch):
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")


@pytest.fixture(scope="module")
def dryrun():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NGSID_STATS_BACKEND", "torch")
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return graft_entry.dryrun_multichip(8)
        finally:
            torch.set_num_threads(threads)


@pytest.mark.parametrize("inputs", ["entry", "seeded"])
def test_entry_forward_equals_jax(rng, inputs):
    fn, (model, x) = graft_entry.entry()
    assert next(model.parameters()).device == x.device == CPU
    assert tuple(x.shape) == (2, 64, port.N_FEATURES)
    assert x.dtype == torch.float32 and not x.any()
    params = ref.init_params(jax.random.PRNGKey(0))
    model.load_state_dict(port.params_from_jax(_flat(params)))
    if inputs == "seeded":
        x = torch.from_numpy(rng.standard_normal(tuple(x.shape))
                             .astype(np.float32))
    with torch.no_grad():
        got = fn(model, x).numpy()
    want = np.asarray(ref.forward(params, jnp.asarray(x.numpy())))
    assert got.shape == want.shape == (2, 64, port.N_CLASSES)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mesh_shape_is_the_references():
    assert [graft_entry._mesh_shape(n) for n in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (1, 2), (3, 1), (1, 4), (3, 2), (2, 4)]


def test_shard_round_trip():
    flat = port.params_to_jax(port.init_params(3))
    shards = [graft_entry._shard(flat, t, 4) for t in range(4)]
    assert shards[1]["fwd/wh"].shape == (128, 96)
    assert shards[1]["out_w"].shape == (64, port.N_CLASSES)
    back = graft_entry._unshard(shards)
    assert sorted(back) == sorted(flat)
    for key in flat:
        assert np.array_equal(back[key], flat[key]), key


def test_dryrun_train_step_within_tolerances(dryrun):
    train = dryrun["train"]
    assert train["mesh"] == [2, 4] and train["hidden"] == 128
    assert train["batch"] == [4, 64, port.N_FEATURES]
    assert train["loss_rel_gap"] <= graft_entry.LOSS_RTOL
    assert train["grad_max_abs_gap"] <= graft_entry.GRAD_ATOL
    assert train["adam_max_abs_gap"] <= graft_entry.ADAM_ATOL


def test_dryrun_step_matches_jax(dryrun):
    feats, labels, mask = graft_entry._batch(2)
    flat = port.params_to_jax(port.init_params(0))
    params = {"embed": flat["embed"], "out_w": flat["out_w"],
              "out_b": flat["out_b"]}
    for d in ("fwd", "bwd"):
        params[d] = {w: flat[f"{d}/{w}"] for w in ("wx", "wh", "b")}
    params = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.value_and_grad(ref.loss_fn)(params, feats, labels,
                                                  mask)
    assert abs(dryrun["train"]["loss"] - float(loss)) <= 1e-6
    want = _flat(grads)
    got = dryrun["train"]["grads"]
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-7,
                                   err_msg=key)


def test_dryrun_clustering_equals_merge_tree(dryrun):
    clustering = dryrun["clustering"]
    assert clustering["ranks"] == 8 and clustering["reads"] == 36
    assert clustering["clusters"] >= 3
    assert clustering["exchanges"] >= 8 and clustering["exchanges"] % 8 == 0
    assert dryrun["processes"]["ranks"] == 2
