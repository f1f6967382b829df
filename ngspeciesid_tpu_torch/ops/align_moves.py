"""Move-stream alignment: banded semi-global Gotoh DP with an on-device
traceback, returning per-pair alignment op streams.

Port of ngspeciesid_tpu/ops/align_moves_pallas.py.  The stage-4 consumers
(the draft POA's profile fold and the polish pileup, ops/poa.py) need the
alignment itself, not only statistics of its path.  The DP keeps one packed
move byte per cell on the device and walks the optimal path there, so only
an O(n + m)-byte op stream per pair leaves the device:

    bits 0-1  chosen H layer (1 = DIAG, 2 = UP, 3 = LEFT)
    bit  2    E chain opens here (e_open >= e_ext)
    bit  3    F chain opens here (f_open >= f_ext)

Forward sweep: the banded rolling-window wavefront of
:mod:`ngspeciesid_tpu_torch.ops.align_stats` (same window schedule, same
tie-breaks: diag > up > left, a gap opens on >=), with scores only.  Out-of-
band H is unreachable (NEG); E and F run free inside the window, so a
result depends on the chunk's window, and the chunk plan (:func:`_plan`)
is the reference's.  The move byte is stored for every lane of the window:
the traceback can follow an E/F chain across the band's edge.

Traceback: from the endpoint (last row / last column, the later diagonal on
score ties, the row on row/column ties) in state H, one op per anti-
diagonal into ``ops[pair, d]``; it stops at i == 0 or j == 0, or where the
predecessor's lane leaves its diagonal's window.  :func:`_reconstruct` adds
the terminal-gap runs on the host, reproducing ops/align.traceback_moves'
full-span layout: LEFT^j0 UP^i0 <core> LEFT^(m-j_end) UP^(n-i_end).

The DP runs in :func:`moves_rows`, which launches the CUDA kernel
(``csrc/moves_kernel.cu``) for CUDA tensors and its plain PyTorch version
(:func:`moves_rows_plain`) for CPU tensors.  The TPU kernel's VMEM cap on
the move store is gone: the store lives in device memory, so every chunk
runs banded and nothing falls back to the full host DP.
"""

from __future__ import annotations

import collections.abc
import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import stats_backend_default, stats_device
from ..spans import span
from .align import DIAG, LEFT, NEG_INF, UP, _bucket_width
from .align_stats import (
    SeqPool,
    _shift,
    check_chunk,
    end_lanes,
    interior_rows,
    pair_rows,
    padded_rows,
    stage_chunk,
)

#: Launches and pairs of the CUDA kernel, counted where it is launched.
LAUNCHES = 0
PAIRS = 0
#: Launches and pairs of the plain PyTorch version (CPU tensors).
PLAIN_LAUNCHES = 0
PLAIN_PAIRS = 0
#: Guards the counts: ranks that run as threads launch at once.
_COUNT_LOCK = threading.Lock()
#: Pairs of each CUDA launch, in launch order.
SIZES: List[int] = []

#: Pairs per launch.  Kept from the reference: the window schedule is shared
#: by a chunk, so another chunking could change results at the band's edge.
MAX_B = 512


def reset_counts() -> None:
    global LAUNCHES, PAIRS, PLAIN_LAUNCHES, PLAIN_PAIRS
    with _COUNT_LOCK:
        LAUNCHES = PAIRS = PLAIN_LAUNCHES = PLAIN_PAIRS = 0
        SIZES.clear()


# ---------------------------------------------------------------------------
# the DP and traceback: kernel wrapper and its plain PyTorch version
# ---------------------------------------------------------------------------

def moves_rows(pool: torch.Tensor, pm: torch.Tensor, base: torch.Tensor,
               W: int, d_max: int, band: int, match: int = 2,
               mismatch: int = -2, gap_ext: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Endpoint rows and op streams of one chunk: ``best`` (B, 16) int32
    (row score, j, diagonal in columns 0-2; column score, i, diagonal in
    columns 8-10; zeros elsewhere) and ``ops`` (B, base.numel()) uint8, one
    op per anti-diagonal of the traced path, 0 elsewhere.

    pool: uint8 (P,) sequences; pm: int64 (B, 8) rows [len1, len2,
    gap_open, -, -, off1, off2, -]; base: int32 window origin per diagonal,
    at least d_max + 1 long, where d_max >= max(len1 + len2); W: window
    lanes.  CUDA tensors run the kernel, CPU tensors the plain version."""
    check_chunk(pool, pm, base, W, d_max)
    if pool.device.type == "cuda":
        return _moves_rows_cuda(pool, pm, base, W, d_max, band, match,
                                mismatch, gap_ext)
    if pool.device.type == "cpu":
        return moves_rows_plain(pool, pm, base, W, d_max, band, match,
                                mismatch, gap_ext)
    raise ValueError(f"no moves DP for device {pool.device}")


def _moves_rows_cuda(pool, pm, base, W, d_max, band, match, mismatch,
                     gap_ext, geo=None, traceback=True):
    """Launch csrc/moves_kernel.cu on the pool's stream, with the launch
    geometry ``geo`` (a ``cuda_lib.Geometry``; default: the one
    ``cuda_lib.launch_geometry`` picks for W and B).  ``traceback=False``
    runs the forward sweep alone (``ops`` stay zero), to time it."""
    global LAUNCHES, PAIRS
    from . import cuda_lib

    lib = cuda_lib.load()
    B = pm.shape[0]
    dev = pool.device
    if geo is None:
        geo = cuda_lib.launch_geometry("moves", W, B,
                                       cuda_lib.sm_count(dev.index))
    best = torch.empty((B, 16), dtype=torch.int32, device=dev)
    ops = torch.zeros((B, base.numel()), dtype=torch.uint8, device=dev)
    # the move store: one byte per lane of every diagonal's window; freed
    # into the caching allocator after the call, which only reuses it in
    # stream order
    store = torch.empty((B, d_max + 1, W), dtype=torch.uint8, device=dev)
    scratch = None
    if geo.memory:
        scratch = torch.empty(B * lib.ngsid_moves_state_ints(W),
                              dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ngsid_moves_launch(
            pool.data_ptr(), pm.data_ptr(), base.data_ptr(), store.data_ptr(),
            ops.data_ptr(), best.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, W, d_max, base.numel(), band, match, mismatch, gap_ext,
            geo.lanes, geo.warps, geo.pairs, int(geo.memory), int(traceback),
            stream)
    cuda_lib.check(err, "moves kernel launch")
    with _COUNT_LOCK:
        LAUNCHES += 1
        PAIRS += B
        SIZES.append(B)
    return best, ops


def moves_rows_plain(pool, pm, base, W, d_max, band, match=2, mismatch=-2,
                     gap_ext=1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the moves DP: :func:`moves_plain`'s
    ``best`` and ``ops``, counted as a plain launch."""
    global PLAIN_LAUNCHES, PLAIN_PAIRS
    best, ops, _ = moves_plain(pool, pm, base, W, d_max, band, match,
                               mismatch, gap_ext)
    with _COUNT_LOCK:
        PLAIN_LAUNCHES += 1
        PLAIN_PAIRS += pm.shape[0]
    return best, ops


def moves_plain(pool, pm, base, W, d_max, band, match=2, mismatch=-2,
                gap_ext=1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The moves DP in plain PyTorch, uncounted: the same wavefront over
    (B, W) int32 tensors, one Python step per anti-diagonal, the move store
    a (B, d_max + 1, W) uint8 tensor, then the traceback vectorized over the
    batch, one path cell per step.  Returns ``best``, ``ops`` and the move
    store (lane l of diagonal d at ``store[:, d, l]``)."""
    dev = pool.device
    i32, i64 = torch.int32, torch.int64
    B = pm.shape[0]
    NEG = int(NEG_INF)
    gopen = pm[:, 2:3].to(i32)
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    bases = base[: d_max + 1].tolist()
    s1p, s2r = padded_rows(pool, pm, d_max, max(bases) + W)
    dds, i_lo, i_hi, top_ok, left_ok = interior_rows(pm, d_max, band)
    end_lane, end_in = end_lanes(pm, bases, W)
    b2 = torch.arange(B, device=dev).repeat(2)
    end_h = torch.full((d_max + 1, 2 * B), NEG, dtype=i64, device=dev)
    end_ok = torch.zeros((d_max + 1, 2 * B), dtype=torch.bool, device=dev)
    store = torch.zeros((B, d_max + 1, W), dtype=torch.uint8, device=dev)

    fill = torch.full((B, 2), NEG, dtype=i32, device=dev)
    neg = fill[:, :1].expand(B, W)
    hd1 = neg.clone()
    hd1[:, 0] = 0                 # diagonal 0: only cell (0, 0), score 0
    hd2, ee, ff = neg, neg, neg
    for dd in range(1, d_max + 1):
        b0 = bases[dd]
        d1 = b0 - bases[dd - 1]
        d2 = b0 - bases[max(dd - 2, 0)]
        iv = b0 + lanes
        valid = (iv >= i_lo[dd]) & (iv <= i_hi[dd])

        # E: gap in s1 (left), predecessor (i, j-1) on diagonal d-1
        e_open = _shift(hd1, d1, fill) - gopen
        e_ext = _shift(ee, d1, fill) - gap_ext
        enew = torch.maximum(e_open, e_ext)
        # F: gap in s2 (up), predecessor (i-1, j) on diagonal d-1
        f_open = _shift(hd1, d1 - 1, fill) - gopen
        f_ext = _shift(ff, d1 - 1, fill) - gap_ext
        fnew = torch.maximum(f_open, f_ext)
        # diagonal: (i-1, j-1) on diagonal d-2 plus the substitution score
        s2o = d_max - dd + b0
        ismatch = s1p[:, b0: b0 + W] == s2r[:, s2o: s2o + W]
        dnew = _shift(hd2, d2 - 1, fill) + torch.where(ismatch, match,
                                                       mismatch).to(i32)
        # H: the traceback's tie-break, diag > up > left
        h_no_e = torch.maximum(dnew, fnew)
        layer = torch.where(enew > h_no_e, LEFT,
                            torch.where(fnew > dnew, UP, DIAG))
        store[:, dd] = (layer | ((e_open >= e_ext).to(i64) << 2)
                        | ((f_open >= f_ext).to(i64) << 3)).to(torch.uint8)
        hnew = torch.maximum(h_no_e, enew)
        # boundary cells (0, d) in lane 0 when base is 0, and (d, 0) in lane
        # d - base: a path starts there with score 0
        for lane, ok in ((0 if b0 == 0 else -1, top_ok[dd]),
                         (dd - b0, left_ok[dd])):
            if 0 <= lane < W:
                valid[:, lane] = ok
                hnew[:, lane] = torch.where(ok, 0, hnew[:, lane])
        hnew = torch.where(valid, hnew, NEG)
        end_h[dd] = hnew[b2, end_lane[dd]]
        end_ok[dd] = valid[b2, end_lane[dd]] & end_in[dd]
        hd2, hd1, ee, ff = hd1, hnew, enew, fnew

    # trackers [score, coord, diagonal]: a sequential ">=" running max from
    # (NEG_INF, -1, -1), i.e. the latest diagonal among the cells of maximal
    # score >= NEG_INF
    ok = end_ok[1:] & (end_h[1:] >= NEG)
    score = torch.where(ok, end_h[1:], torch.iinfo(i64).min)
    top = score.max(0).values
    pick = torch.where(ok & (score == top), dds[1:], -1).max(0).values
    hit = ok.any(0)
    coord = torch.where(hit, pick - torch.cat((pm[:, 0], pm[:, 1])), -1)
    top = torch.where(hit, top, NEG)
    best = torch.zeros((B, 16), dtype=i32, device=dev)
    for c0, sl in ((0, slice(0, B)), (8, slice(B, 2 * B))):
        best[:, c0] = top[sl].to(i32)
        best[:, c0 + 1] = coord[sl].to(i32)
        best[:, c0 + 2] = pick[sl].to(i32)
    return best, _walk_plain(store, base, best, pm, W), store


def _walk_plain(store, base, best, pm, W) -> torch.Tensor:
    """Traceback of every pair at once, one path cell per step: the path
    crosses each anti-diagonal at most once, so each step writes one op."""
    i64 = torch.int64
    dev = store.device
    B = store.shape[0]
    base64 = base.to(i64)
    ops = torch.zeros((B, base.numel()), dtype=torch.uint8, device=dev)
    use_row = best[:, 0] >= best[:, 8]
    alive = torch.where(use_row, best[:, 0], best[:, 8]) > int(NEG_INF)
    i = torch.where(use_row, pm[:, 0], best[:, 9].to(i64))
    j = torch.where(use_row, best[:, 1].to(i64), pm[:, 1])
    state = torch.zeros(B, dtype=i64, device=dev)      # 0 H, 1 E, 2 F
    rows = torch.arange(B, device=dev)
    flat = store.view(-1)
    stride = store.shape[1] * W
    while True:
        dd = (i + j).clamp(min=0)
        lane = i - base64[dd.clamp(max=base.numel() - 1)]
        alive &= (i >= 1) & (j >= 1) & (lane >= 0) & (lane < W)
        if not bool(alive.any()):
            return ops
        mv = flat[torch.where(alive, rows * stride + dd * W + lane, 0)].to(i64)
        layer = mv & 3
        in_h = state == 0
        diag = alive & in_h & (layer == DIAG)
        left = alive & ((state == 1) | (in_h & (layer == LEFT)))
        up = alive & ~diag & ~left
        op = diag * DIAG + up * UP + left * LEFT
        ops[rows[alive], dd[alive]] = op[alive].to(torch.uint8)
        opened = torch.where(left, (mv >> 2) & 1, (mv >> 3) & 1) > 0
        state = torch.where(diag | opened, 0, torch.where(left, 1, 2))
        i = i - (diag | up).to(i64)
        j = j - (diag | left).to(i64)


# ---------------------------------------------------------------------------
# host side: chunk plan, staging, reconstruction
# ---------------------------------------------------------------------------

def _plan(seqs, rows1, rows2) -> List[List[int]]:
    """Split request indices into chunks of at most MAX_B pairs sharing one
    (bucket(len1), bucket(len2)) key, in the reference's order."""
    order = sorted(
        range(len(rows1)),
        key=lambda i: (_bucket_width(seqs[rows1[i]].size),
                       _bucket_width(seqs[rows2[i]].size)))
    chunks: List[List[int]] = []
    cur: List[int] = []
    cur_key = None
    for i in order:
        key = (_bucket_width(seqs[rows1[i]].size),
               _bucket_width(seqs[rows2[i]].size))
        if cur and (key != cur_key or len(cur) >= MAX_B):
            chunks.append(cur)
            cur = []
        cur_key = key
        cur.append(i)
    if cur:
        chunks.append(cur)
    return chunks


def _reconstruct(best, ops, len1, len2) -> List[np.ndarray]:
    out = []
    for b in range(len1.size):
        n_b, m_b = int(len1[b]), int(len2[b])
        use_row = best[b, 0] >= best[b, 8]
        if best[b, 0] <= NEG_INF // 2 and best[b, 8] <= NEG_INF // 2:
            # no reachable endpoint (empty band): all-gap alignment
            out.append(np.concatenate([
                np.full(m_b, LEFT, np.uint8), np.full(n_b, UP, np.uint8)]))
            continue
        end_i = n_b if use_row else int(best[b, 9])
        end_j = int(best[b, 1]) if use_row else m_b
        core = ops[b][ops[b] != 0].astype(np.uint8)
        nd = int((core == DIAG).sum())
        nu = int((core == UP).sum())
        nl = int((core == LEFT).sum())
        i0 = end_i - nd - nu
        j0 = end_j - nd - nl
        out.append(np.concatenate([
            np.full(j0, LEFT, np.uint8), np.full(i0, UP, np.uint8), core,
            np.full(m_b - end_j, LEFT, np.uint8),
            np.full(n_b - end_i, UP, np.uint8)]))
    return out


class MovesChunk(NamedTuple):
    """One launched chunk of :func:`launch_moves_pool`, still on the
    device: the request indices of its pairs in launch order, its pair
    table ``pm`` ((B, 8) int64: len1, len2, gap_open, -, -, off1, off2, -;
    offsets into the call's pool tensor), the kernel's ``best`` and ``ops``
    (:func:`moves_rows`) and the host-side lengths."""
    idx: List[int]
    pm: torch.Tensor
    best: torch.Tensor
    ops: torch.Tensor
    len1: np.ndarray
    len2: np.ndarray


def launch_moves_pool(
    seqs: Sequence[np.ndarray],
    rows1: Sequence[int],
    rows2: Sequence[int],
    gap_opens: Sequence[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    band: int = 0,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, List[MovesChunk]]:
    """Launch the moves DP of every pair (the chunk plan of :func:`_plan`,
    each chunk on the current stream) and return the pool tensor that holds
    the call's rows with the launched chunks, nothing copied back: the
    launches under :func:`sg_moves_pool_torch`.  ``device`` as there."""
    if device is None:
        device = stats_device(stats_backend_default())
    with span("moves.stage"):
        pool = SeqPool(torch.device(device))
        buf = pool.ensure([seqs[r] for r in
                           dict.fromkeys(list(rows1) + list(rows2))])
        launched = []
        for sl in _plan(seqs, rows1, rows2):
            B = len(sl)
            pm, base, W, d_max, len1, len2 = stage_chunk(
                pool, seqs, [rows1[i] for i in sl], [rows2[i] for i in sl],
                [gap_opens[i] for i in sl], [0] * B, [0] * B, band)
            best, ops = moves_rows(buf, pm, base, W, d_max, band, match,
                                   mismatch, gap_ext)
            launched.append(MovesChunk(sl, pm, best, ops, len1, len2))
    return buf, launched


class PoolMoves(collections.abc.Sequence):
    """What :func:`sg_moves_pool_torch` returns: the call's launched chunks,
    still on the device (``buf`` and ``chunks``, as :func:`launch_moves_pool`
    returns them), for consumers that read the traced paths there
    (``ops/pileup.py``); read as a sequence, each pair's full-span move
    array.  The first read copies every chunk back and reconstructs the
    call's moves (the spans ``moves.wait`` and ``moves.reconstruct``) and
    lets go of the device tensors."""

    def __init__(self, n_pairs: int, buf: torch.Tensor,
                 chunks: List[MovesChunk]) -> None:
        self.buf: Optional[torch.Tensor] = buf
        self.chunks: Optional[List[MovesChunk]] = chunks
        self._n = n_pairs
        self._moves: Optional[List[np.ndarray]] = None

    def _read(self) -> List[np.ndarray]:
        if self._moves is None:
            out: List[Optional[np.ndarray]] = [None] * self._n
            for ch in self.chunks:
                with span("moves.wait"):
                    best, ops = ch.best.cpu().numpy(), ch.ops.cpu().numpy()
                with span("moves.reconstruct"):
                    res = _reconstruct(best, ops, ch.len1, ch.len2)
                for i, r in zip(ch.idx, res):
                    out[i] = r
            self._moves = out  # type: ignore[assignment]
            self.buf = self.chunks = None
        return self._moves

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return self._read()[i]

    def __iter__(self):
        return iter(self._read())


def sg_moves_pool_torch(
    seqs: Sequence[np.ndarray],
    rows1: Sequence[int],
    rows2: Sequence[int],
    gap_opens: Sequence[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    band: int = 0,
    device: Optional[torch.device] = None,
) -> Sequence[np.ndarray]:
    """Per pair: the full-span move array (terminal gaps included) of
    ``seqs[rows1[p]]`` against ``seqs[rows2[p]]``, identical in layout to
    ops/align.sg_align_batch, computed on ``device`` (a CUDA device runs
    the kernel, the CPU the plain version; default:
    ``stats_device(stats_backend_default())``, so ``cuda:0`` unless the
    caller asks for the CPU).  The call's rows cross to the device once;
    every chunk is launched on the current stream before any result is
    copied back, which happens at the first read of the returned
    :class:`PoolMoves` (an empty list for no pairs)."""
    n_pairs = len(rows1)
    if n_pairs == 0:
        return []
    buf, launched = launch_moves_pool(seqs, rows1, rows2, gap_opens, match,
                                      mismatch, gap_ext, band, device)
    return PoolMoves(n_pairs, buf, launched)


def sg_moves_batch_torch(pairs, gap_opens, match=2, mismatch=-2, gap_ext=1,
                         band=0, device=None) -> List[np.ndarray]:
    """Pairs-of-arrays wrapper over :func:`sg_moves_pool_torch`; repeated
    array objects share one pool row.  ``device=None``: the configured
    backend's device, as there."""
    seqs, rows1, rows2 = pair_rows(pairs)
    return list(sg_moves_pool_torch(seqs, rows1, rows2, gap_opens,
                                    match=match, mismatch=mismatch,
                                    gap_ext=gap_ext, band=band,
                                    device=device))
