"""Full (unbanded) semi-global Gotoh DP with its traceback on the device:
one op stream per pair.

Port of ngspeciesid_tpu/ops/align_pallas.py.  Cell (i, j) lies on diagonal
dd = i + j at lane i:

    E[dd][i] = max(H[dd-1][i]   - open, E[dd-1][i]   - ext)   # from (i, j-1)
    F[dd][i] = max(H[dd-1][i-1] - open, F[dd-1][i-1] - ext)   # from (i-1, j)
    H[dd][i] = max(H[dd-2][i-1] + sub(s1[i-1], s2[j-1]), E, F)

H is 0 on row 0 and column 0 and NEG outside the pair's cells; E and F are
not masked (they only flow to larger i or j, so they never reach a valid
cell from outside).  The move byte of every cell holds the chosen H layer
in bits 0-1 (LEFT if E > max(diag, F), UP if F > diag, else DIAG), "E
opens here" in bit 2 and "F opens here" in bit 3 (a gap opens on >=).
Running trackers keep the best last-row and last-column cells with ``>=``,
so the later diagonal wins ties; the traceback starts at the row when its
score is >= the column's (the corner-most tie-break of ops/align.py).

The TPU kernel writes the whole move matrix and the host traces it back.
Here the DP is the moves wavefront (ops/align_moves.py) in a fixed full
frame: window origin 0 on every diagonal, W = :func:`lanes_for` (n) lanes,
band 0.  Every cell of every matrix lies in the window, so the traceback
runs on the device, its op streams are ``_traceback_diag``'s, and only the
endpoint rows and the op streams leave it; the move store stays device
scratch.  :func:`full_dp_rows` launches the CUDA kernel
(``csrc/full_dp_kernel.cu``) for CUDA tensors and runs
:func:`full_dp_rows_plain` (``align_moves.moves_plain`` with a zero window
origin) for CPU tensors.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import stats_backend_default, stats_device
from .align_moves import _reconstruct, moves_plain
from .align_stats import SeqPool, check_chunk

#: Launches and pairs of the CUDA kernel, counted where it is launched.
LAUNCHES = 0
PAIRS = 0
#: Launches and pairs of the plain PyTorch version (CPU tensors).
PLAIN_LAUNCHES = 0
PLAIN_PAIRS = 0
#: Guards the counts: ranks that run as threads launch at once.
_COUNT_LOCK = threading.Lock()

#: Lanes cover i = 0..n, rounded up to this many.
LANE_TILE = 128
#: Move-store bytes of one launch, (n + m + 1) x W a pair; larger batches
#: are split.  A pair's result does not depend on the other pairs of its
#: launch.
MAX_STORE_BYTES = 1 << 30


def reset_counts() -> None:
    global LAUNCHES, PAIRS, PLAIN_LAUNCHES, PLAIN_PAIRS
    with _COUNT_LOCK:
        LAUNCHES = PAIRS = PLAIN_LAUNCHES = PLAIN_PAIRS = 0


def lanes_for(n: int) -> int:
    """Lane count of a launch whose longest s1 has n bytes."""
    return -(-(n + 1) // LANE_TILE) * LANE_TILE


# ---------------------------------------------------------------------------
# the DP and traceback: kernel wrapper and its plain PyTorch version
# ---------------------------------------------------------------------------

def full_dp_rows(pool: torch.Tensor, pm: torch.Tensor, W: int, d_max: int,
                 match: int = 2, mismatch: int = -2, gap_ext: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Endpoint rows and op streams of a batch: ``best`` (B, 16) int32 (row
    score, j, diagonal in columns 0-2; column score, i, diagonal in columns
    8-10; zeros elsewhere) and ``ops`` (B, d_max + 1) uint8, one op per
    anti-diagonal of the traced path, 0 elsewhere.

    pool: uint8 (P,) sequences; pm: int64 (B, 8) rows [len1, len2,
    gap_open, -, -, off1, off2, -]; W: lanes, a multiple of LANE_TILE above
    every len1; d_max >= every len1 + len2.  CUDA tensors run the kernel,
    CPU tensors the plain version."""
    check_chunk(pool, pm, None, W, d_max)
    if W % LANE_TILE:
        raise ValueError(f"W must be a multiple of {LANE_TILE}, got {W}")
    if pool.device.type == "cuda":
        return _full_dp_rows_cuda(pool, pm, W, d_max, match, mismatch,
                                  gap_ext)
    if pool.device.type == "cpu":
        return full_dp_rows_plain(pool, pm, W, d_max, match, mismatch,
                                  gap_ext)
    raise ValueError(f"no full DP for device {pool.device}")


def _full_dp_rows_cuda(pool, pm, W, d_max, match, mismatch, gap_ext,
                       geo=None, traceback=True):
    """Launch csrc/full_dp_kernel.cu on the pool's stream, with the launch
    geometry ``geo`` (a ``cuda_lib.Geometry``; default: the moves kernel's,
    ``cuda_lib.launch_geometry("moves", W, B, sms)``).
    ``traceback=False`` runs the forward sweep alone (``ops`` stay zero),
    to time it."""
    global LAUNCHES, PAIRS
    from . import cuda_lib

    lib = cuda_lib.load()
    B = pm.shape[0]
    dev = pool.device
    if geo is None:
        geo = cuda_lib.launch_geometry("moves", W, B,
                                       cuda_lib.sm_count(dev.index))
    best = torch.empty((B, 16), dtype=torch.int32, device=dev)
    ops = torch.zeros((B, d_max + 1), dtype=torch.uint8, device=dev)
    # the move store: device scratch, never copied to the host; freed into
    # the caching allocator after the call, which only reuses it in stream
    # order
    store = torch.empty((B, d_max + 1, W), dtype=torch.uint8, device=dev)
    scratch = None
    if geo.memory:
        scratch = torch.empty(B * lib.ngsid_moves_state_ints(W),
                              dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ngsid_full_dp_launch(
            pool.data_ptr(), pm.data_ptr(), store.data_ptr(), ops.data_ptr(),
            best.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, W, d_max, match, mismatch, gap_ext, geo.lanes, geo.warps,
            geo.pairs, int(geo.memory), int(traceback), stream)
    cuda_lib.check(err, "full DP kernel launch")
    with _COUNT_LOCK:
        LAUNCHES += 1
        PAIRS += B
    return best, ops


def full_dp_rows_plain(pool, pm, W, d_max, match=2, mismatch=-2, gap_ext=1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the full DP: the moves DP's plain version
    (``align_moves.moves_plain``) in the fixed frame, window origin 0 on
    every diagonal and band 0."""
    global PLAIN_LAUNCHES, PLAIN_PAIRS
    base = torch.zeros(d_max + 1, dtype=torch.int32, device=pool.device)
    best, ops, _ = moves_plain(pool, pm, base, W, d_max, 0, match, mismatch,
                               gap_ext)
    with _COUNT_LOCK:
        PLAIN_LAUNCHES += 1
        PLAIN_PAIRS += pm.shape[0]
    return best, ops


# ---------------------------------------------------------------------------
# host side: staging and reconstruction
# ---------------------------------------------------------------------------

def stage_pairs(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                gap_opens: Sequence[int], device: torch.device):
    """The arguments of :func:`full_dp_rows` for ``pairs`` on ``device``
    (the pool of their sequences, each distinct array once; the (B, 8) pair
    table; W; d_max = n + m, the longest s1 and s2), then the host-side
    lengths."""
    pool = SeqPool(device)
    buf = pool.ensure([s for pair in pairs for s in pair])
    B = len(pairs)
    len1 = np.fromiter((a.size for a, _ in pairs), np.int64, count=B)
    len2 = np.fromiter((b.size for _, b in pairs), np.int64, count=B)
    pm = np.zeros((B, 8), np.int64)
    pm[:, 0] = len1
    pm[:, 1] = len2
    pm[:, 2] = gap_opens
    pm[:, 5] = pool.offsets([a for a, _ in pairs])
    pm[:, 6] = pool.offsets([b for _, b in pairs])
    n, m = int(len1.max()), int(len2.max())
    return (buf, torch.from_numpy(pm).to(device), lanes_for(n), n + m,
            len1, len2)


def sg_align_batch_full(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    device: Optional[torch.device] = None,
) -> List[np.ndarray]:
    """Per pair: the full-span move array (terminal gaps included) of the
    full DP, identical to ops/align.sg_align_batch at band 0, computed on
    ``device`` (default: ``stats_device(stats_backend_default())``, so
    ``cuda:0`` unless the caller asks for the CPU).  Every launch is queued
    before any result is copied back, and only the endpoint rows and op
    streams are."""
    if not pairs:
        return []
    if device is None:
        device = stats_device(stats_backend_default())
    n = max(a.size for a, _ in pairs)
    m = max(b.size for _, b in pairs)
    step = max(1, MAX_STORE_BYTES // ((n + m + 1) * lanes_for(n)))
    launched = []
    for s in range(0, len(pairs), step):
        *args, len1, len2 = stage_pairs(pairs[s: s + step],
                                        gap_opens[s: s + step],
                                        torch.device(device))
        best, ops = full_dp_rows(*args, match, mismatch, gap_ext)
        launched.append((best, ops, len1, len2))
    out: List[np.ndarray] = []
    for best, ops, len1, len2 in launched:
        out += _reconstruct(best.cpu().numpy(), ops.cpu().numpy(), len1, len2)
    return out
