"""The port's GRU training (ngspeciesid_tpu_torch.models.train and the
training half of models/polisher.py) against the JAX package, on the CPU.

NGSID_STATS_BACKEND=torch: the examples' alignments run in the moves
kernel's plain PyTorch version, the reference's in its native engine.

- Examples: ``make_example`` draws from the generator in the reference's
  order, so one seed gives bit-equal features, labels and mask.
- One step from the in-repo weights on one seeded batch (batch 2, window
  64): the loss within atol 1e-6 and every gradient within rtol 1e-4,
  atol 1e-7 of ``jax.value_and_grad(loss_fn)`` (float32 on both sides;
  2e-8 and 2e-9 were measured, against a loss of 1.1e-3 and gradients up
  to 1.2e-3).  The optimizer is held on its own: JAX's gradients go into
  the port's Adam and the weights must be within atol 1e-6 of
  ``optax.adam(1e-3)``'s update of the same gradients.  (A step in which
  each side used its own gradients is not compared: Adam's first step is
  -lr * g / (|g| + eps), so float32 noise on a gradient near zero can move
  a weight by up to 2 * lr.)
- The weights' round trip through ``params_to_jax`` is bit-equal, and no
  gradient reaches ``nn.GRU``'s ``bias_hh``.
- The CLI writes an npz that both packages load.
"""

import sys

import jax
import numpy as np
import optax
import pytest
import torch

from ngspeciesid_tpu.models import polisher as ref
from ngspeciesid_tpu.models import train as ref_train
from ngspeciesid_tpu_torch.models import polisher as port
from ngspeciesid_tpu_torch.models import train as port_train
from ngspeciesid_tpu_torch.ops import align_moves

from .test_torch_polisher import MODEL, REF_MODEL

CPU = torch.device("cpu")
LR = 1e-3


@pytest.fixture(autouse=True)
def torch_backend(monkeypatch):
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain DP runs many small ops per diagonal, which extra intra-op
    threads only slow down (and the suite runs several workers at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    """A JAX parameter tree flattened as its npz stores it."""
    out = {}
    for key, node in tree.items():
        if isinstance(node, dict):
            out.update(_flat(node, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(node)
    return out


def _npz(path):
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


@pytest.fixture(scope="module")
def batch():
    """One step's batch (2 examples, window 64) from seed 0."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NGSID_STATS_BACKEND", "torch")
        return port_train.make_batch(np.random.default_rng(0), 2, 64)


@pytest.mark.parametrize("seed, window", [(0, 64), (1, 256), (2, 640)])
def test_make_example_equal_to_reference(monkeypatch, seed, window):
    """Window 640 is longer than any draft: the padded branch."""
    rng = np.random.default_rng(seed)
    monkeypatch.delenv("NGSID_STATS_BACKEND")
    want = ref_train.make_example(rng, int(rng.integers(250, 600)), window)
    after = rng.random()
    monkeypatch.setenv("NGSID_STATS_BACKEND", "torch")
    rng = np.random.default_rng(seed)
    align_moves.reset_counts()
    got = port_train.make_example(rng, int(rng.integers(250, 600)), window)
    # the pileup's reads and the band-0 draft-to-template pair
    assert align_moves.PLAIN_PAIRS > 1 and align_moves.LAUNCHES == 0
    assert rng.random() == after          # the same draws, in the same order
    for g, w, dtype in zip(got, want, (np.float32, np.int32, np.float32)):
        assert g.dtype == w.dtype == dtype
        assert g.shape == w.shape
        assert np.array_equal(g, w)
    if window == 640:
        assert not got[2][-1] and got[2].sum() > 200


def test_one_step_loss_and_gradients_match_jax(batch):
    params = ref_train.load_params(REF_MODEL)
    loss, grads = jax.value_and_grad(ref.loss_fn)(params, *batch)
    want = port.params_from_jax(_flat(grads))

    model = port.load_params(MODEL, CPU)
    step = port.make_train_step(model, LR)
    got = step(*(torch.from_numpy(a) for a in batch))
    assert abs(float(got) - float(loss)) <= 1e-6
    for name, p in model.named_parameters():
        if name in port.HIDDEN_BIASES:
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_adam_matches_optax_on_the_same_gradients(batch):
    """Two steps, so the moments and the bias correction past step 1 are
    held too."""
    params = ref_train.load_params(REF_MODEL)
    grads = jax.grad(ref.loss_fn)(params, *batch)
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    model = port.load_params(MODEL, CPU)
    step = port.make_train_step(model, LR)
    for scale in (1.0, -0.5):
        g = jax.tree_util.tree_map(lambda x: scale * x, grads)
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        torch_g = port.params_from_jax(_flat(g))
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch_g[name].clone()
        step.optimizer.step()
    want = _flat(params)
    got = port.params_to_jax(model.state_dict())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)


def test_params_to_jax_round_trip_bit_equal():
    flat = _npz(MODEL)
    back = port.params_to_jax(port.params_from_jax(flat))
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        assert back[key].dtype == value.dtype == np.float32
        assert back[key].tobytes() == value.tobytes(), key
    state = port.init_params(3, hidden=8)
    again = port.params_from_jax(port.params_to_jax(state))
    assert sorted(again) == sorted(state)
    for key, value in state.items():
        assert torch.equal(again[key], value), key


def test_init_params_scale_and_seed():
    a, b = port.init_params(0), port.init_params(0)
    flat = port.params_to_jax(a)
    assert flat["fwd/wx"].shape == (port.HIDDEN, 3 * port.HIDDEN)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed.weight"], port.init_params(1)["embed.weight"])
    assert 0.07 < float(flat["fwd/wh"].std()) < 0.09
    for key in ("fwd/b", "bwd/b", "out_b"):
        assert not flat[key].any()


def test_no_gradient_reaches_bias_hh(batch):
    model = port.load_params(MODEL, CPU)
    step = port.make_train_step(model, LR)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(2):
        step(*(torch.from_numpy(a) for a in batch))
    trained = {id(p) for group in step.optimizer.param_groups
               for p in group["params"]}
    for key in port.HIDDEN_BIASES:
        p = model.get_parameter(key)
        assert not p.requires_grad and p.grad is None and id(p) not in trained
        assert not p.any()
    assert not torch.equal(before["gru.weight_hh_l0"],
                           model.state_dict()["gru.weight_hh_l0"])
    state = model.state_dict()
    state["gru.bias_hh_l0"] = torch.full_like(state["gru.bias_hh_l0"], 0.5)
    with pytest.raises(ValueError, match="bias_hh_l0 is not all zero"):
        port.params_to_jax(state)


def test_cli_writes_an_npz_both_packages_load(tmp_path, monkeypatch, capsys):
    out = tmp_path / "gru.npz"
    monkeypatch.setattr(sys, "argv", [
        "train", "--out", str(out), "--steps", "2", "--batch", "2",
        "--window", "64", "--seed", "5"])
    port_train.main()
    assert "step 0 loss" in capsys.readouterr().out
    flat = _npz(out)
    ref_params = ref_train.load_params(str(out))
    assert sorted(_flat(ref_params)) == sorted(flat)
    model = port_train.load_params(str(out))
    assert next(model.parameters()).device == CPU and not model.training
    feats = np.random.default_rng(0).random((1, 64, port.N_FEATURES),
                                            dtype=np.float32)
    np.testing.assert_allclose(
        port.forward_logits(model, feats),
        np.asarray(ref.forward(ref_params, feats)), rtol=0, atol=1e-5)
    # two Adam steps of about lr each moved the weights off the seed's
    init = port.params_to_jax(port.init_params(5))
    moved = np.abs(flat["fwd/wx"] - init["fwd/wx"])
    assert 1.5 * LR < moved.max() < 4 * LR
