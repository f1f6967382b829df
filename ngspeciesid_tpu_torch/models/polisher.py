"""Neural pileup polisher: the learned medaka-class head.

Port of ngspeciesid_tpu/models/polisher.py (its serving half; training is
not ported yet).  Per-position pileup features -> input projection -> a
bidirectional GRU over the sequence axis -> 5-way symbol head (A, C, G, T,
deletion).

The weights are the JAX package's (``data/polisher_gru.npz``, written by
its models/train.py), carried over by :func:`params_from_jax`.  The JAX cell
orders its gate blocks z, r, n and has a bias only on the input side, with
the n gate ``tanh(gx_n + r * gh_n)``; ``nn.GRU`` orders them r, z, n and has
a second bias inside the n gate's product, so the loader reorders the
blocks and sets ``bias_hh`` to zero.

Pileup features (N_FEATURES per position): base counts (4), deletion count,
quality-weighted base counts (4), insertion-open count, coverage, draft base
one-hot (4), bias.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

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
    ``nn.GRU``'s r, z, n."""
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
    f32 = {k: np.asarray(v, dtype=np.float32) for k, v in flat.items()}
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


def load_params(path: str, device: torch.device) -> GRUPolisher:
    """A :class:`GRUPolisher` on ``device``, in eval mode, with the weights
    of a JAX params npz (models/train.py's ``save_params`` layout)."""
    with np.load(path) as data:
        flat = {key: data[key] for key in data.files}
    state = params_from_jax(flat)
    model = GRUPolisher(hidden=state["embed.weight"].shape[0])
    model.load_state_dict(state)
    return model.to(device).eval()


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


def forward_logits(model: GRUPolisher, features: np.ndarray) -> np.ndarray:
    """Logits of (B, L, N_FEATURES) float32 features, on the model's
    device, as a numpy array."""
    dev = next(model.parameters()).device
    with torch.no_grad(), _full_fp32():
        logits = model(torch.from_numpy(features).to(dev))
    FORWARDS[str(dev)] = FORWARDS.get(str(dev), 0) + 1
    return logits.cpu().numpy()


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
