"""Neural pileup polisher: the learned medaka-class head.

Port of ngspeciesid_tpu/models/polisher.py.  Per-position pileup features
-> input projection -> a bidirectional GRU over the sequence axis -> 5-way
symbol head (A, C, G, T, deletion).

The weights are the JAX package's (``data/polisher_gru.npz``, written by
its models/train.py), carried over by :func:`params_from_jax`.  The JAX cell
orders its gate blocks z, r, n and has a bias only on the input side, with
the n gate ``tanh(gx_n + r * gh_n)``; ``nn.GRU`` orders them r, z, n and has
a second bias inside the n gate's product, so the loader reorders the
blocks and sets ``bias_hh`` to zero.

The training half (:func:`init_params`, :func:`loss_fn`,
:func:`make_train_step`, used by models/train.py) keeps ``bias_hh`` zero
and frozen, so a trained model is still a JAX cell, and
:func:`params_to_jax` writes it back in the JAX layout.

Pileup features (N_FEATURES per position): base counts (4), deletion count,
quality-weighted base counts (4), insertion-open count, coverage, draft base
one-hot (4), bias.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..spans import count, span

N_FEATURES = 16
N_CLASSES = 5  # A C G T deletion
HIDDEN = 128
#: A round's features are zero-padded to a multiple of this length, as in
#: the JAX round: the backward scan starts at the padded end, so the padding
#: changes the logits of real positions and is part of the contract.
PAD = 256

#: GRU forwards by the device they ran on, e.g. {"cuda:0": 50}.
FORWARDS: Dict[str, int] = {}


class GRUPolisher(nn.Module):
    """features (B, L, N_FEATURES) -> logits (B, L, N_CLASSES)."""

    def __init__(self, hidden: int = HIDDEN):
        super().__init__()
        self.embed = nn.Linear(N_FEATURES, hidden, bias=False)
        self.gru = nn.GRU(hidden, hidden, batch_first=True,
                          bidirectional=True)
        self.out = nn.Linear(2 * hidden, N_CLASSES)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        h, _ = self.gru(self.embed(features))
        return self.out(h)


def _jax_shapes(hidden: int) -> Dict[str, tuple]:
    shapes = {"embed": (N_FEATURES, hidden), "out_w": (2 * hidden, N_CLASSES),
              "out_b": (N_CLASSES,)}
    for d in ("fwd", "bwd"):
        shapes.update({f"{d}/wx": (hidden, 3 * hidden),
                       f"{d}/wh": (hidden, 3 * hidden),
                       f"{d}/b": (3 * hidden,)})
    return shapes


def _rzn(w: np.ndarray) -> np.ndarray:
    """Gate blocks along the last axis from the JAX order z, r, n to
    ``nn.GRU``'s r, z, n, and back: the swap is its own inverse."""
    z, r, n = np.split(w, 3, axis=-1)
    return np.concatenate([r, z, n], axis=-1)


def params_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The weights carry-over: the JAX parameter tree, flattened as its npz
    stores it (``embed``, ``fwd/{wx,wh,b}``, ``bwd/{wx,wh,b}``, ``out_w``,
    ``out_b``), as a :class:`GRUPolisher` ``state_dict``.  Raises ValueError
    on a missing or unknown key or a wrong shape."""
    if "embed" not in flat:
        raise ValueError("GRU params: key 'embed' missing")
    hidden = int(np.shape(flat["embed"])[-1])
    want = _jax_shapes(hidden)
    if set(flat) != set(want):
        raise ValueError(
            f"GRU params: keys {sorted(flat)}, expected {sorted(want)}")
    for key, shape in want.items():
        if tuple(np.shape(flat[key])) != shape:
            raise ValueError(f"GRU params: {key} has shape "
                             f"{tuple(np.shape(flat[key]))}, expected {shape}")
    f32 = {k: np.array(v, dtype=np.float32) for k, v in flat.items()}
    state = {"embed.weight": f32["embed"].T,
             "out.weight": f32["out_w"].T,
             "out.bias": f32["out_b"]}
    for d, suffix in (("fwd", "l0"), ("bwd", "l0_reverse")):
        state[f"gru.weight_ih_{suffix}"] = _rzn(f32[f"{d}/wx"]).T
        state[f"gru.weight_hh_{suffix}"] = _rzn(f32[f"{d}/wh"]).T
        state[f"gru.bias_ih_{suffix}"] = _rzn(f32[f"{d}/b"])
        state[f"gru.bias_hh_{suffix}"] = np.zeros(3 * hidden, np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}


#: The ``nn.GRU`` biases that the JAX cell does not have.
HIDDEN_BIASES = ("gru.bias_hh_l0", "gru.bias_hh_l0_reverse")


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_jax`: a :class:`GRUPolisher`
    ``state_dict`` as the JAX parameter tree, flattened as its npz stores it
    (gate blocks back from r, z, n to z, r, n, weights transposed back).
    Raises ValueError on a missing or unknown key, or on a ``bias_hh`` that
    is not all zero (the JAX cell has no place for it)."""
    want = {"embed.weight", "out.weight", "out.bias"}
    for suffix in ("l0", "l0_reverse"):
        want |= {f"gru.{w}_{suffix}" for w in
                 ("weight_ih", "weight_hh", "bias_ih", "bias_hh")}
    if set(state) != want:
        raise ValueError(
            f"GRU state: keys {sorted(state)}, expected {sorted(want)}")
    f32 = {k: v.detach().cpu().numpy().astype(np.float32)   # a copy
           for k, v in state.items()}
    for key in HIDDEN_BIASES:
        if f32[key].any():
            raise ValueError(f"GRU state: {key} is not all zero, and the "
                             f"JAX layout has no hidden-side bias")
    flat = {"embed": f32["embed.weight"].T}
    for d, suffix in (("fwd", "l0"), ("bwd", "l0_reverse")):
        flat[f"{d}/wx"] = _rzn(f32[f"gru.weight_ih_{suffix}"].T)
        flat[f"{d}/wh"] = _rzn(f32[f"gru.weight_hh_{suffix}"].T)
        flat[f"{d}/b"] = _rzn(f32[f"gru.bias_ih_{suffix}"])
    flat["out_w"] = f32["out.weight"].T
    flat["out_b"] = f32["out.bias"]
    return {k: np.ascontiguousarray(v) for k, v in flat.items()}


def init_params(seed: int, hidden: int = HIDDEN) -> Dict[str, torch.Tensor]:
    """Fresh weights as a :class:`GRUPolisher` ``state_dict``: the JAX
    initialisation's shapes and scale (normal x 0.08, zero biases), drawn
    from a ``torch.Generator`` seeded with ``seed`` and carried over by
    :func:`params_from_jax`.  It cannot reproduce ``jax.random``'s draws:
    the two packages start training from different weights."""
    gen = torch.Generator().manual_seed(seed)
    flat = {}
    for key, shape in _jax_shapes(hidden).items():
        if len(shape) == 1:
            flat[key] = np.zeros(shape, np.float32)
        else:
            flat[key] = (0.08 * torch.randn(shape, generator=gen)).numpy()
    return params_from_jax(flat)


def model_from_state(state: Mapping[str, torch.Tensor],
                     device: torch.device) -> GRUPolisher:
    """A :class:`GRUPolisher` on ``device`` holding ``state``."""
    model = GRUPolisher(hidden=state["embed.weight"].shape[0])
    model.load_state_dict(state)
    return model.to(device)


def load_params(path: str, device: torch.device) -> GRUPolisher:
    """A :class:`GRUPolisher` on ``device``, in eval mode, with the weights
    of a JAX params npz (models/train.py's ``save_params`` layout)."""
    with np.load(path) as data:
        flat = {key: data[key] for key in data.files}
    return model_from_state(params_from_jax(flat), device).eval()


@contextlib.contextmanager
def _full_fp32():
    """cuDNN's RNN and float32 matmuls in full float32: TF32 would move the
    logits by about 1e-3 and could flip a call against the CPU's."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def loss_fn(model: GRUPolisher, features: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Masked mean cross-entropy of the logits of (B, L, N_FEATURES)
    features against (B, L) int labels, weighted by a (B, L) float mask."""
    logits = model(features)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         labels.reshape(-1).long(), reduction="none")
    return (ce * mask.reshape(-1)).sum() / torch.clamp(mask.sum(), min=1.0)


def make_train_step(model: GRUPolisher, lr: float = 1e-3):
    """The counterpart of the JAX ``make_train_step(optax.adam(lr))``:
    ``step(features, labels, mask) -> loss`` takes the gradient of
    :func:`loss_fn` by autograd and one ``torch.optim.Adam`` step, whose
    defaults (b1 0.9, b2 0.999, eps 1e-8 added after the square root, bias
    correction) are ``optax.adam``'s.  Forward and backward run in full
    float32 (no TF32).  ``bias_hh`` stays zero: it is frozen and left out
    of the optimizer.  The optimizer is ``step.optimizer``."""
    for key in HIDDEN_BIASES:
        model.get_parameter(key).requires_grad_(False)
    model.train()   # cuDNN's RNN backward runs only in training mode
    optimizer = torch.optim.Adam(
        [p for p in model.parameters() if p.requires_grad], lr=lr)

    def step(features, labels, mask):
        optimizer.zero_grad(set_to_none=True)
        with _full_fp32():
            loss = loss_fn(model, features, labels, mask)
            loss.backward()
        optimizer.step()
        return loss.detach()

    step.optimizer = optimizer
    return step


def forward_logits(model: GRUPolisher, features: np.ndarray) -> np.ndarray:
    """Logits of (B, L, N_FEATURES) float32 features, on the model's
    device, as a numpy array."""
    dev = next(model.parameters()).device
    with span("polisher.forward"):
        with torch.no_grad(), _full_fp32():
            logits = model(torch.from_numpy(features).to(dev))
        out = logits.cpu().numpy()
    FORWARDS[str(dev)] = FORWARDS.get(str(dev), 0) + 1
    count("polisher.forwards")
    return out


def neural_polish_round(model: GRUPolisher, center: np.ndarray, reads,
                        quals) -> np.ndarray:
    """Medaka-class neural polishing: pileup features -> GRU -> per-position
    symbol call (A/C/G/T/deletion); insertions come from the pileup majority
    rule (same as ops/poa.polish_round).  Uncovered positions keep the draft.
    """
    from ..ops.poa import pileup_stats  # local import: avoid cycle

    if not reads or center.size == 0:
        return center
    st = pileup_stats(center, reads, quals)
    feats = pileup_features(center, st.votes, st.qvotes, st.ins_open, st.coverage)
    L = center.size
    Lp = -(-L // PAD) * PAD
    fpad = np.zeros((1, Lp, N_FEATURES), dtype=np.float32)
    fpad[0, :L] = feats
    logits = forward_logits(model, fpad)[0, :L]
    cls = logits.argmax(axis=1)          # numpy's first-max rule, as JAX's
    out = []
    cov = st.coverage
    base_bytes = np.frombuffer(b"ACGT", dtype=np.uint8)
    for p in range(L + 1):
        if st.ins_votes[p]:
            total_ins = sum(st.ins_votes[p].values())
            if total_ins > cov[p] / 2.0:
                best = sorted(st.ins_votes[p].items(), key=lambda kv: (-kv[1], kv[0]))[0]
                out.extend(best[0])
        if p < L:
            if st.votes[p].sum() == 0.0:
                out.append(int(center[p]))
            elif cls[p] < 4:
                out.append(int(base_bytes[cls[p]]))
            # cls 4 = deletion: emit nothing
    return np.array(out, dtype=np.uint8)


def pileup_features(
    center: np.ndarray, votes: np.ndarray, qvotes: np.ndarray,
    ins_open: np.ndarray, coverage: np.ndarray,
) -> np.ndarray:
    """Assemble the (L, N_FEATURES) tensor from pileup statistics."""
    L = center.size
    feats = np.zeros((L, N_FEATURES), dtype=np.float32)
    feats[:, 0:5] = votes
    feats[:, 5:9] = qvotes[:, :4]
    feats[:, 9] = ins_open[:L]
    feats[:, 10] = coverage[:L]
    for i, b in enumerate(b"ACGT"):
        feats[:, 11 + i] = center == b
    feats[:, 15] = 1.0
    denom = np.maximum(coverage[:L], 1.0)[:, None]
    feats[:, 0:5] /= denom
    feats[:, 5:9] /= denom
    feats[:, 9] /= denom[:, 0]
    feats[:, 10] = np.log1p(feats[:, 10])
    return feats
