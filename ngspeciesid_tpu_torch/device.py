"""Stats backend choice and the device it runs on.

``NGSID_STATS_BACKEND`` picks where every alignment runs: the clustering
engine's fallback statistics, and stage 4's draft POA, RC-merge identity
and polish pileup (the counterpart of the reference's
``stats_backend_default``, ngspeciesid_tpu/ops/align.py):

  cuda    the hand-written CUDA kernels on ``cuda:0`` (default)
  torch   the kernels' plain PyTorch versions on CPU tensors
  native  the port's copy of the C++ engine (native/sgdp.cpp)
  host    numpy mirrors: statistics from a traceback (through the C++
          engine when it builds), moves from the numpy DP

The GRU polisher (``--medaka_model <params npz>``) follows the same choice
(:func:`polisher_device`): it runs on ``cuda:0`` under ``cuda``, and on the
CPU under ``torch``, ``native`` and ``host``, which are CPU runs the caller
chose.

Choosing ``cuda`` on a machine without a visible CUDA device raises: the port
never moves device work to the CPU on its own.
"""

from __future__ import annotations

import os

import torch

BACKENDS = ("cuda", "torch", "native", "host")


def stats_backend_default() -> str:
    """The configured stats backend (``NGSID_STATS_BACKEND``, default cuda)."""
    env = os.environ.get("NGSID_STATS_BACKEND", "").strip().lower() or "cuda"
    if env not in BACKENDS:
        raise ValueError(
            f"NGSID_STATS_BACKEND={env!r}: expected one of {', '.join(BACKENDS)}")
    return env


def stats_device(backend: str) -> torch.device:
    """The device a torch backend runs on: ``cuda:0`` for ``cuda`` (raises
    when no CUDA device is visible), the CPU for ``torch``."""
    if backend == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "NGSID_STATS_BACKEND=cuda but torch sees no CUDA device; "
                "set NGSID_STATS_BACKEND to torch, native or host to run on "
                "the CPU")
        return torch.device("cuda", 0)
    if backend == "torch":
        return torch.device("cpu")
    raise ValueError(f"backend {backend!r} does not run on a torch device")


def polisher_device(backend: str) -> torch.device:
    """The device the GRU polisher runs on under ``backend``: ``cuda:0``
    for ``cuda`` (raises when no CUDA device is visible), else the CPU."""
    return stats_device("cuda") if backend == "cuda" else torch.device("cpu")
