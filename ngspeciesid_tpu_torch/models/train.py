"""Training pipeline for the neural pileup polisher.

Port of ngspeciesid_tpu/models/train.py.  Self-supervised on synthetic
amplicons: sample a template, simulate a noisy draft plus ONT-like reads,
build the pileup feature tensor against the draft (ops/poa.pileup_stats,
the moves kernel at the polish band), and label every draft position with
the true symbol (template base or deletion) obtained by aligning draft to
template at band 0 (the moves kernel again).  The bidirectional GRU
(models/polisher.py) then learns the medaka-class correction map pileup
features -> correct symbol, by autograd and Adam on the polisher's device.

The examples are numpy and draw from ``rng`` in the reference's order, so
one seed gives the same examples in both packages; the initial weights do
not (polisher.init_params).  The trained weights are written in the JAX
package's npz layout, which both packages load.

Run:  python -m ngspeciesid_tpu_torch.models.train --out ngspeciesid_tpu_torch/data/polisher_gru.npz
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import polisher_device, stats_backend_default
from ..ops.align import DIAG, LEFT, UP, sg_align_batch
from ..ops.poa import pileup_stats
from . import polisher
from .polisher import N_FEATURES, init_params, make_train_step, pileup_features

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_BASE_CLASS = np.full(256, 4, dtype=np.int32)  # default: deletion class
for _i, _b in enumerate(b"ACGT"):
    _BASE_CLASS[_b] = _i


def mutate(rng, template: np.ndarray, e: float) -> Tuple[np.ndarray, np.ndarray]:
    out: List[int] = []
    quals: List[int] = []
    for c in template:
        r = rng.random()
        if r < e / 3:
            continue
        out.append(int(c))
        quals.append(int(rng.integers(33 + 8, 33 + 28)))
        if r < 2 * e / 3:
            out.append(int(ACGT[rng.integers(0, 4)]))
            quals.append(int(rng.integers(33 + 8, 33 + 28)))
        elif r < e:
            out[-1] = int(ACGT[rng.integers(0, 4)])
    return np.array(out, dtype=np.uint8), np.array(quals, dtype=np.uint8)


def draft_labels(draft: np.ndarray, template: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-draft-position true symbol class (0-3 base, 4 deletion) + mask."""
    moves = sg_align_batch([(draft, template)], [3], band=0)[0]
    labels = np.full(draft.size, 4, dtype=np.int32)
    mask = np.zeros(draft.size, dtype=np.float32)
    di = ti = 0
    for mv in moves:
        if mv == DIAG:
            labels[di] = _BASE_CLASS[template[ti]]
            mask[di] = 1.0
            di += 1
            ti += 1
        elif mv == UP:       # draft base absent from template -> deletion
            labels[di] = 4
            mask[di] = 1.0
            di += 1
        else:
            ti += 1
    return labels, mask


def make_example(rng, tlen: int, window: int):
    e_draft = rng.uniform(0.005, 0.03)
    e_read = rng.uniform(0.03, 0.12)
    depth = int(rng.integers(10, 40))
    template = ACGT[rng.integers(0, 4, size=tlen)]
    draft, _ = mutate(rng, template, e_draft)
    reads, quals = zip(*(mutate(rng, template, e_read) for _ in range(depth)))
    st = pileup_stats(draft, list(reads), list(quals))
    feats = pileup_features(draft, st.votes, st.qvotes, st.ins_open, st.coverage)
    labels, mask = draft_labels(draft, template)
    # crop/pad to the training window
    L = draft.size
    if L >= window:
        s = int(rng.integers(0, L - window + 1))
        return feats[s : s + window], labels[s : s + window], mask[s : s + window]
    fpad = np.zeros((window, N_FEATURES), np.float32)
    lpad = np.zeros(window, np.int32)
    mpad = np.zeros(window, np.float32)
    fpad[:L], lpad[:L], mpad[:L] = feats, labels, mask
    return fpad, lpad, mpad


def make_batch(rng, batch: int, window: int):
    """One step's examples, stacked: (feats, labels, mask) numpy arrays."""
    ex = [make_example(rng, int(rng.integers(250, 600)), window)
          for _ in range(batch)]
    return tuple(np.stack([e[i] for e in ex]) for i in range(3))


def train(steps: int = 300, batch: int = 16, window: int = 256,
          seed: int = 0, lr: float = 1e-3, out: str = "polisher_gru.npz",
          log_every: int = 25) -> polisher.GRUPolisher:
    """Train from :func:`polisher.init_params` on the polisher's device
    (``cuda:0`` under NGSID_STATS_BACKEND=cuda, else the CPU), write the
    weights to ``out`` and return the trained model."""
    rng = np.random.default_rng(seed)
    device = polisher_device(stats_backend_default())
    model = polisher.model_from_state(init_params(seed), device)
    step_fn = make_train_step(model, lr)
    t0 = time.time()
    for step in range(steps):
        feats, labels, mask = (torch.from_numpy(a).to(device)
                               for a in make_batch(rng, batch, window))
        loss = step_fn(feats, labels, mask)
        if step % log_every == 0:
            print(f"step {step} loss {float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    save_params(model, out)
    print(f"saved {out}")
    return model


def save_params(model: polisher.GRUPolisher, path: str) -> None:
    """Write the weights in the JAX package's npz layout."""
    np.savez_compressed(path, **polisher.params_to_jax(model.state_dict()))


def load_params(path: str,
                device: Optional[torch.device] = None) -> polisher.GRUPolisher:
    """A params npz (either package's) as a :class:`GRUPolisher` in eval
    mode, on ``device`` (default: the polisher's device)."""
    if device is None:
        device = polisher_device(stats_backend_default())
    return polisher.load_params(path, device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="ngspeciesid_tpu_torch/data/polisher_gru.npz")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    train(steps=args.steps, batch=args.batch, window=args.window,
          seed=args.seed, out=args.out)


if __name__ == "__main__":
    main()
