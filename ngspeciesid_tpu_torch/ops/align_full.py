"""Full (unbanded) semi-global Gotoh DP over anti-diagonals: the whole
packed move matrix of each pair leaves the device and is traced back on the
host.

Port of ngspeciesid_tpu/ops/align_pallas.py.  Cell (i, j) lies on diagonal
dd = i + j at lane i:

    E[dd][i] = max(H[dd-1][i]   - open, E[dd-1][i]   - ext)   # from (i, j-1)
    F[dd][i] = max(H[dd-1][i-1] - open, F[dd-1][i-1] - ext)   # from (i-1, j)
    H[dd][i] = max(H[dd-2][i-1] + sub(s1[i-1], s2[j-1]), E, F)

H is 0 on row 0 and column 0 and NEG outside the pair's cells; E and F are
not masked (they only flow to larger i or j, so they never reach a valid
cell from outside).  The move word of every interior cell is

    bits 0-1  chosen H layer (1 = DIAG, 2 = UP, 3 = LEFT): LEFT if
              E > max(diag, F), UP if F > diag, else DIAG
    bit  2    E chain opens here (e_open >= e_ext)
    bit  3    F chain opens here (f_open >= f_ext)

and 0 elsewhere.  The moves are stored in DIAGONAL layout, cell (i, j) at
``moves[pair, i + j - 1, i]``, as uint8 holding the TPU kernel's int32
words.  Running trackers keep the best last-row and last-column cells with
``>=``, so the later diagonal wins ties; the host takes the row when its
score is >= the column's (the corner-most tie-break of ops/align.py).

:func:`full_dp_rows` launches the CUDA kernel (``csrc/full_dp_kernel.cu``)
for CUDA tensors and runs :func:`full_dp_rows_plain` for CPU tensors.  The
TPU's reversed, padded s2 row and its dynamic lane roll are gone: the
kernel indexes s2 directly, the plain version slices a reversed copy.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import stats_backend_default, stats_device
from .align import DIAG, LEFT, NEG_INF, UP, traceback_moves

#: Launches and pairs of the CUDA kernel, counted where it is launched.
LAUNCHES = 0
PAIRS = 0
#: Launches and pairs of the plain PyTorch version (CPU tensors).
PLAIN_LAUNCHES = 0
PLAIN_PAIRS = 0

#: Lanes cover i = 0..n, rounded up to this many.
LANE_TILE = 128
#: The kernel's widest row: 1024 threads of at most 8 lanes each.
MAX_LANES = 8192
#: Move-store bytes of one launch; larger batches are split.  A pair's moves
#: do not depend on the other pairs of its launch, only the layout does.
MAX_STORE_BYTES = 1 << 30


def reset_counts() -> None:
    global LAUNCHES, PAIRS, PLAIN_LAUNCHES, PLAIN_PAIRS
    LAUNCHES = PAIRS = PLAIN_LAUNCHES = PLAIN_PAIRS = 0


def lanes_for(n: int) -> int:
    """Lane count of a launch whose longest s1 has n bytes."""
    return -(-(n + 1) // LANE_TILE) * LANE_TILE


def _check(s1: torch.Tensor, s2: torch.Tensor, meta: torch.Tensor) -> None:
    B = s1.shape[0]
    if s1.dtype != torch.uint8 or s2.dtype != torch.uint8:
        raise TypeError("s1 and s2 must be uint8")
    if meta.dtype != torch.int32 or tuple(meta.shape) != (B, 3):
        raise ValueError(f"meta must be ({B}, 3) int32, got "
                         f"{tuple(meta.shape)} {meta.dtype}")
    if s1.dim() != 2 or s2.dim() != 2 or s2.shape[0] != B:
        raise ValueError("s1 and s2 must be (B, n) and (B, m)")
    if not (s1.device == s2.device == meta.device):
        raise ValueError("s1, s2 and meta must share a device")
    if not (s1.is_contiguous() and s2.is_contiguous()
            and meta.is_contiguous()):
        raise ValueError("s1, s2 and meta must be contiguous")


# ---------------------------------------------------------------------------
# the DP: kernel wrapper and its plain PyTorch version
# ---------------------------------------------------------------------------

def full_dp_rows(s1: torch.Tensor, s2: torch.Tensor, meta: torch.Tensor,
                 match: int = 2, mismatch: int = -2, gap_ext: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Moves and endpoint trackers of a batch: ``moves`` (B, n + m, L)
    uint8 in diagonal layout (L = :func:`lanes_for` (n)) and ``best`` (B, 4)
    int32 rows [row_best, row_j, col_best, col_i].

    s1: (B, n) and s2: (B, m) uint8, each row's sequence first (the rest is
    ignored); meta: (B, 3) int32 rows [len1, len2, gap_open].  CUDA tensors
    run the kernel, CPU tensors the plain version."""
    _check(s1, s2, meta)
    if s1.device.type == "cuda":
        return _full_dp_rows_cuda(s1, s2, meta, match, mismatch, gap_ext)
    if s1.device.type == "cpu":
        return full_dp_rows_plain(s1, s2, meta, match, mismatch, gap_ext)
    raise ValueError(f"no full DP for device {s1.device}")


def _full_dp_rows_cuda(s1, s2, meta, match, mismatch, gap_ext):
    global LAUNCHES, PAIRS
    from . import cuda_lib

    lib = cuda_lib.load()
    B, n = s1.shape
    m = s2.shape[1]
    L = lanes_for(n)
    if L > MAX_LANES:
        raise ValueError(f"full DP kernel: s1 of {n} bytes needs {L} lanes, "
                         f"more than its {MAX_LANES}")
    dev = s1.device
    moves = torch.empty((B, n + m, L), dtype=torch.uint8, device=dev)
    best = torch.empty((B, 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ngsid_full_dp_launch(
            s1.data_ptr(), s2.data_ptr(), meta.data_ptr(), moves.data_ptr(),
            best.data_ptr(), B, n, m, L, match, mismatch, gap_ext, stream)
    cuda_lib.check(err, "full DP kernel launch")
    LAUNCHES += 1
    PAIRS += B
    return moves, best


def _shift1(x: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """Lane i takes lane i - 1; lane 0 takes ``fill``."""
    return torch.cat((fill, x[:, :-1]), dim=1)


def full_dp_rows_plain(s1, s2, meta, match=2, mismatch=-2, gap_ext=1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the full DP: one vectorized step per anti-
    diagonal over (B, L) int32 tensors, the TPU kernel's arithmetic."""
    global PLAIN_LAUNCHES, PLAIN_PAIRS
    dev = s1.device
    i32 = torch.int32
    NEG = int(NEG_INF)
    B, n = s1.shape
    m = s2.shape[1]
    L = lanes_for(n)
    D = n + m
    lanes = torch.arange(L, dtype=i32, device=dev)[None, :]
    len1, len2, gopen = meta[:, 0:1], meta[:, 1:2], meta[:, 2:3]
    # lane i holds s1[i - 1]; s2[j - 1] = s2[dd - 1 - i] is a slice of the
    # reversed row, padded by L on both sides
    s1l = torch.zeros((B, L), dtype=i32, device=dev)
    s1l[:, 1: n + 1] = s1.to(i32)
    s2r = torch.full((B, m + 2 * L), -1, dtype=i32, device=dev)
    s2r[:, L: L + m] = s2.flip(1).to(i32)

    fill = torch.full((B, 1), NEG, dtype=i32, device=dev)
    h1 = torch.where(lanes == 0, 0, fill)        # diagonal 0: cell (0, 0)
    h2 = fill.expand(B, L)                       # diagonal -1
    ee = ff = h2
    moves = torch.zeros((B, D, L), dtype=torch.uint8, device=dev)
    # trackers [row_best, row_j, col_best, col_i]
    best = torch.cat((fill, fill * 0, fill, fill * 0), dim=1)
    rows = torch.arange(B, device=dev)
    for dd in range(1, D + 1):
        j_of = dd - lanes
        valid = (lanes <= len1) & (j_of >= 0) & (j_of <= len2)

        e_open = h1 - gopen
        e_ext = ee - gap_ext
        enew = torch.maximum(e_open, e_ext)
        f_open = _shift1(h1, fill) - gopen
        f_ext = _shift1(ff, fill) - gap_ext
        fnew = torch.maximum(f_open, f_ext)
        s2c = s2r[:, m - dd + L: m - dd + 2 * L]
        sub = torch.where(s1l == s2c, match, mismatch).to(i32)
        diag = _shift1(h2, fill) + sub

        h_no_e = torch.maximum(diag, fnew)
        boundary = (lanes == 0) | (j_of == 0)
        hnew = torch.where(boundary, 0, torch.maximum(h_no_e, enew))
        hnew = torch.where(valid, hnew, fill)
        layer = torch.where(enew > h_no_e, LEFT,
                            torch.where(fnew > diag, UP, DIAG))
        packed = (layer | ((e_open >= e_ext).to(i32) << 2)
                  | ((f_open >= f_ext).to(i32) << 3))
        moves[:, dd - 1] = torch.where(valid & ~boundary, packed,
                                       0).to(torch.uint8)

        # the last row's cell is at lane len1, the last column's at dd - len2
        row_j = dd - len1[:, 0]
        row_ok = (row_j >= 0) & (row_j <= len2[:, 0])
        row_h = hnew[rows, len1[:, 0].long()]
        take = row_ok & (row_h >= best[:, 0])
        best[:, 0] = torch.where(take, row_h, best[:, 0])
        best[:, 1] = torch.where(take, row_j, best[:, 1])
        col_i = dd - len2[:, 0]
        col_ok = (col_i >= 0) & (col_i <= len1[:, 0])
        col_h = hnew[rows, col_i.clamp(0, L - 1).long()]
        take = col_ok & (col_h >= best[:, 2])
        best[:, 2] = torch.where(take, col_h, best[:, 2])
        best[:, 3] = torch.where(take, col_i, best[:, 3])
        h2, h1, ee, ff = h1, hnew, enew, fnew
    PLAIN_LAUNCHES += 1
    PLAIN_PAIRS += B
    return moves, best


# ---------------------------------------------------------------------------
# host side: staging, endpoint choice, traceback
# ---------------------------------------------------------------------------

def stage_pairs(pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
                gap_opens: Sequence[int], device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(s1, s2, meta) of :func:`full_dp_rows` for ``pairs`` on ``device``,
    each sequence zero-padded to the batch's longest."""
    B = len(pairs)
    n = max(a.size for a, _ in pairs)
    m = max(b.size for _, b in pairs)
    s1 = np.zeros((B, n), dtype=np.uint8)
    s2 = np.zeros((B, m), dtype=np.uint8)
    meta = np.zeros((B, 3), dtype=np.int32)
    for p, (a, b) in enumerate(pairs):
        s1[p, : a.size] = a
        s2[p, : b.size] = b
        meta[p] = (a.size, b.size, gap_opens[p])
    return tuple(torch.from_numpy(x).to(device) for x in (s1, s2, meta))


def sg_align_batch_full(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    device: Optional[torch.device] = None,
) -> List[np.ndarray]:
    """Per pair: the full-span move array (terminal gaps included) of the
    full DP, identical to ops/align.sg_align_batch at band 0, computed on
    ``device`` (default: ``stats_device(stats_backend_default())``, so
    ``cuda:0`` unless the caller asks for the CPU)."""
    if not pairs:
        return []
    if device is None:
        device = stats_device(stats_backend_default())
    n = max(a.size for a, _ in pairs)
    m = max(b.size for _, b in pairs)
    per_pair = max(1, (n + m) * lanes_for(n))
    step = max(1, MAX_STORE_BYTES // per_pair)
    out: List[np.ndarray] = []
    for s in range(0, len(pairs), step):
        chunk = pairs[s: s + step]
        moves, best = full_dp_rows(*stage_pairs(chunk, gap_opens[s: s + step],
                                                torch.device(device)),
                                   match, mismatch, gap_ext)
        moves = moves.cpu().numpy()
        best = best.cpu().numpy()
        for p, (a, b) in enumerate(chunk):
            row_best, row_j, col_best, col_i = best[p, :4]
            if row_best >= col_best:
                end = (a.size, int(row_j))
            else:
                end = (int(col_i), b.size)
            out.append(traceback_moves(row_view(moves[p], a.size, b.size),
                                       a.size, b.size, end))
    return out


def row_view(moves_diag: np.ndarray, n: int, m: int) -> np.ndarray:
    """The (n + 1, m) row-layout view of one pair's diagonal-layout moves
    that ops/align.traceback_moves reads: view[i, j - 1] is
    moves_diag[i + j - 1, i].  It copies nothing, and its last cell,
    [n + m - 1, n], lies inside the (>= n + m, > n) matrix."""
    rs, cs = moves_diag.strides
    return np.lib.stride_tricks.as_strided(
        moves_diag, (n + 1, m), (rs + cs, rs), writeable=False)
