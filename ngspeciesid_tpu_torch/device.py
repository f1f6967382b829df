"""Stats backend choice and the device it runs on.

``NGSID_STATS_BACKEND`` picks where the clustering engine's fallback
alignments run (the counterpart of the reference's ``stats_backend_default``,
ngspeciesid_tpu/ops/align.py):

  cuda    the hand-written CUDA kernel on ``cuda:0`` (default)
  torch   the kernel's plain PyTorch version on CPU tensors
  native  the shared C++ engine (ngspeciesid_tpu/native)
  host    numpy traceback mirror (through the C++ engine when it builds)

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
