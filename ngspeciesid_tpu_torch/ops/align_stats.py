"""Stats-only alignment: banded semi-global Gotoh DP with path statistics.

Port of ngspeciesid_tpu/ops/align_stats_pallas.py.  The consumers of the
alignment never need the alignment itself, only two statistics of its
optimal path (reference cluster.py:144-169 and consensus.py:129-145): the
number of k-column windows with >= match_id matches, and matches / columns.
Every cell's move choice is a deterministic function of the cell (the
traceback's tie-break: diag > up > left, a gap opens on >=), so the
statistics of the optimal path are carried FORWARD beside the scores, six
int32 fields per layer and cell:

    score | hist (last-k match bits) | wsum (matches in the current window)
    wcount (windows with wsum >= match_id) | mcount (matches)
    colcount (alignment columns so far, incl. leading terminal gaps)

The DP sweeps anti-diagonals through a window whose origin ``base[d]`` the
host precomputes per chunk (:func:`_window_schedule`); band 0 is the exact
full DP.  Each pair leaves the device as 16 int32 (last-row and last-column
endpoint trackers); :func:`_gather_chunk` adds the trailing terminal gaps on
the host.  Semantics with band=0 equal match_vector + block_aligned_stats +
identity_from_moves over the traceback of ops/align.py, bit for bit.

The DP runs in :func:`stats_rows`, which launches the CUDA kernel
(``csrc/stats_kernel.cu``) for CUDA tensors and its plain PyTorch version
(:func:`stats_rows_plain`) for CPU tensors; for a CUDA tensor it launches
the kernel or raises.  Sequences live in a per-device pool
(:class:`SeqPool`): each distinct host row crosses to the device once.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import stats_backend_default, stats_device
from ..spans import span
from .align import NEG_INF, _bucket_width

MAX_K = 30  # history bits must fit int32

#: Launches and pairs of the CUDA kernel, counted where it is launched.
LAUNCHES = 0
PAIRS = 0
#: Launches and pairs of the plain PyTorch version (CPU tensors).
PLAIN_LAUNCHES = 0
PLAIN_PAIRS = 0
#: Pairs of each CUDA launch, in launch order.
SIZES: List[int] = []
#: Guards the counts: ranks that run as threads launch at once.
_COUNT_LOCK = threading.Lock()
#: One plain DP at a time in a process: it is a Python step per diagonal of
#: small tensor ops, each of which releases the interpreter lock, so two
#: threads running it at once hand that lock back and forth at every op
#: and take several times longer together than one after the other.
_PLAIN_LOCK = threading.Lock()


def reset_counts() -> None:
    global LAUNCHES, PAIRS, PLAIN_LAUNCHES, PLAIN_PAIRS
    with _COUNT_LOCK:
        LAUNCHES = PAIRS = PLAIN_LAUNCHES = PLAIN_PAIRS = 0
        SIZES.clear()


class SeqPool:
    """Sequence rows resident on one device: a uint8 tensor plus the byte
    offset of each row, keyed on ``id(row)``.  Each distinct row crosses to
    the device once; the pool keeps a reference to every row it holds, so
    the id stays valid.  Appends never move a row; the tensor grows by copy
    into one twice as large.

    Threads may share a pool (ranks that run as threads share the process's
    pools): :meth:`ensure` and :meth:`offsets` hold the pool's lock, and
    :meth:`ensure` returns the tensor that holds the rows.  A launch reads
    that tensor, never ``buf``, which a concurrent grow replaces; the old
    tensor keeps every row it held and stays alive while a launch holds
    it."""

    CAP_MIN = 1 << 22

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._off: Dict[int, int] = {}
        self._keep: Dict[int, np.ndarray] = {}
        self._used = 0
        self._lock = threading.Lock()
        self.buf = torch.empty(self.CAP_MIN, dtype=torch.uint8, device=device)

    def ensure(self, rows: Sequence[np.ndarray]) -> torch.Tensor:
        """Copy the rows not yet resident to the device, in one transfer;
        return the tensor that holds every row of ``rows``."""
        with self._lock:
            missing = {id(r): r for r in rows if id(r) not in self._off}
            if not missing:
                return self.buf
            size = sum(r.size for r in missing.values())
            need = self._used + size
            buf = self.buf
            if need > buf.numel():
                cap = buf.numel()
                while cap < need:
                    cap *= 2
                grown = torch.empty(cap, dtype=torch.uint8, device=self.device)
                grown[: self._used] = buf[: self._used]
                buf = grown
            chunk = np.concatenate(list(missing.values()))
            buf[self._used: need] = torch.from_numpy(chunk).to(self.device)
            off = self._used
            for key, r in missing.items():
                self._off[key] = off
                self._keep[key] = r
                off += r.size
            self._used = need
            self.buf = buf
            return buf

    def offsets(self, rows: Sequence[np.ndarray]) -> np.ndarray:
        """The byte offsets of resident ``rows``, int64."""
        with self._lock:
            return np.fromiter((self._off[id(r)] for r in rows), np.int64,
                               count=len(rows))

    def offset(self, row: np.ndarray) -> int:
        with self._lock:
            return self._off[id(row)]


_POOLS: Dict[torch.device, SeqPool] = {}
_POOLS_LOCK = threading.Lock()


def device_pool(device: torch.device) -> SeqPool:
    """The process-wide pool of ``device`` (rows stay resident across calls,
    waves and sub-rounds of a clustering run)."""
    with _POOLS_LOCK:
        pool = _POOLS.get(device)
        if pool is None:
            pool = _POOLS[device] = SeqPool(device)
        return pool


# ---------------------------------------------------------------------------
# the DP: kernel wrapper and its plain PyTorch version
# ---------------------------------------------------------------------------

def check_chunk(pool: torch.Tensor, pm: torch.Tensor,
                base: Optional[torch.Tensor], W: int, d_max: int) -> None:
    """Raise ValueError unless a chunk's inputs are what the kernels take:
    a contiguous 1-D uint8 pool, a contiguous (B, 8) int64 pair table and a
    contiguous int32 window schedule of at least d_max + 1 diagonals (None:
    a fixed frame, which reads none), on one device, with a positive window
    width."""
    if pool.dtype != torch.uint8 or pool.dim() != 1 or not pool.is_contiguous():
        raise ValueError("pool must be a contiguous 1-D uint8 tensor")
    if pm.dtype != torch.int64 or pm.dim() != 2 or pm.shape[1] != 8 \
            or not pm.is_contiguous():
        raise ValueError("pm must be a contiguous (B, 8) int64 tensor")
    if W <= 0:
        raise ValueError(f"window width must be positive, got {W}")
    if pool.device != pm.device:
        raise ValueError("pool and pm must be on one device")
    if base is None:
        return
    if base.dtype != torch.int32 or base.dim() != 1 or not base.is_contiguous():
        raise ValueError("base must be a contiguous 1-D int32 tensor")
    if base.numel() <= d_max:
        raise ValueError(f"base holds {base.numel()} diagonals, need {d_max + 1}")
    if base.device != pool.device:
        raise ValueError("pool, pm and base must be on one device")


def stats_rows(pool: torch.Tensor, pm: torch.Tensor, base: torch.Tensor,
               W: int, d_max: int, band: int, match: int = 2,
               mismatch: int = -2, gap_ext: int = 1) -> torch.Tensor:
    """Raw endpoint rows of one chunk: (B, 16) int32, row tracker in columns
    0-7 and column tracker in 8-15, each [score, coord, hist, wsum, wcount,
    mcount, colcount, diagonal].

    pool: uint8 (P,) sequences; pm: int64 (B, 8) rows [len1, len2, gap_open,
    k, match_id, off1, off2, 0]; base: int32 window origin per diagonal,
    at least d_max + 1 long, where d_max >= max(len1 + len2); W: window
    lanes.  CUDA tensors run the kernel, CPU tensors the plain version."""
    check_chunk(pool, pm, base, W, d_max)
    if pool.device.type == "cuda":
        return _stats_rows_cuda(pool, pm, base, W, d_max, band, match,
                                mismatch, gap_ext)
    if pool.device.type == "cpu":
        with _PLAIN_LOCK:
            return stats_rows_plain(pool, pm, base, W, d_max, band, match,
                                    mismatch, gap_ext)
    raise ValueError(f"no stats DP for device {pool.device}")


def _stats_rows_cuda(pool, pm, base, W, d_max, band, match, mismatch,
                     gap_ext, geo=None):
    """Launch csrc/stats_kernel.cu on the pool's stream, with the launch
    geometry ``geo`` (a ``cuda_lib.Geometry``; default: the one
    ``cuda_lib.launch_geometry`` picks for W and B)."""
    global LAUNCHES, PAIRS
    from . import cuda_lib

    lib = cuda_lib.load()
    B = pm.shape[0]
    dev = pool.device
    if geo is None:
        geo = cuda_lib.launch_geometry("stats", W, B,
                                       cuda_lib.sm_count(dev.index))
    out = torch.empty((B, 16), dtype=torch.int32, device=dev)
    scratch = None
    if geo.memory:
        # one state slab per pair; freed into the caching allocator after
        # the call, which only reuses it in stream order
        scratch = torch.empty(B * lib.ngsid_stats_state_ints(W),
                              dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ngsid_stats_launch(
            pool.data_ptr(), pm.data_ptr(), base.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, W, d_max, band, match, mismatch, gap_ext, geo.lanes,
            geo.warps, geo.pairs, int(geo.memory), stream)
    cuda_lib.check(err, "stats kernel launch")
    with _COUNT_LOCK:
        LAUNCHES += 1
        PAIRS += B
        SIZES.append(B)
    return out


def _shift(x: torch.Tensor, off: int, fill: torch.Tensor) -> torch.Tensor:
    """out[..., l] = x[..., l + off] where 0 <= l + off < W, else ``fill``
    (score NEG_INF, stats 0; |off| <= fill's width): the TPU kernel's
    _shift_lanes."""
    if off > 0:
        return torch.cat((x[..., off:], fill[..., :off]), -1)
    if off < 0:
        return torch.cat((fill[..., :-off], x[..., :off]), -1)
    return x


def _sel(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where the int32 0/1 mask ``m`` is 1, else ``b`` (arithmetic:
    torch.where is several times slower on CPU integer tensors)."""
    return b + (a - b) * m


def _push(st: torch.Tensor, bit, km1, kk, mid, mask) -> None:
    """Advance (6, B, W) path stats by one alignment column with match
    ``bit`` (None: a gap column), in place (_push_column)."""
    h, ws, wc, mc, cc = st[1], st[2], st[3], st[4], st[5]
    exiting = (h >> km1) & 1
    if bit is None:
        st[1] = (h << 1) & mask
        ws -= exiting
    else:
        st[1] = ((h << 1) | bit) & mask
        ws += bit - exiting
        mc += bit
    cc += 1
    wc += (cc >= kk) & (ws >= mid)


def padded_rows(pool: torch.Tensor, pm: torch.Tensor, d_max: int, hi: int):
    """The pair's sequences as padded int32 rows, so that each diagonal's
    substitution column is a slice: s1p[:, i] = s1[i - 1] and
    s2r[:, d_max - j] = s2[j - 1], with -1 / -2 outside the sequence (never
    equal).  ``hi``: one past the last row index any window reaches."""
    i32 = torch.int32
    dev = pool.device
    len1, len2 = pm[:, 0:1], pm[:, 1:2]
    last = pool.numel() - 1
    x = torch.arange(hi, device=dev)[None, :]
    s1p = torch.where((x >= 1) & (x <= len1),
                      pool[(pm[:, 5:6] + x - 1).clamp(0, last)].to(i32), -1)
    y = torch.arange(d_max + hi, device=dev)[None, :]
    j = d_max - y
    s2r = torch.where((j >= 1) & (j <= len2),
                      pool[(pm[:, 6:7] + j - 1).clamp(0, last)].to(i32), -2)
    return s1p, s2r


def interior_rows(pm: torch.Tensor, d_max: int, band: int):
    """Per diagonal and pair: the diagonal index ``dds`` (D+1, 1), the rows
    [i_lo, i_hi] (D+1, B, 1) of its interior cells (the band test solved for
    i; exact in integers), and whether its boundary cells (0, d) and (d, 0)
    exist (D+1, B) bool."""
    i32, i64 = torch.int32, torch.int64
    dds = torch.arange(d_max + 1, dtype=i64, device=pm.device)[:, None]
    L1, L2 = pm[:, 0][None, :], pm[:, 1][None, :]
    i_lo = torch.clamp(dds - L2, min=1)
    i_hi = torch.minimum(L1, dds - 1)
    if band > 0:
        tot = L1 + L2
        i_lo = torch.maximum(i_lo, -torch.div(-(dds - band) * L1, tot,
                                              rounding_mode="floor"))
        i_hi = torch.minimum(i_hi, torch.div((dds + band + 1) * L1 - 1, tot,
                                             rounding_mode="floor"))
    return (dds, i_lo.to(i32)[..., None], i_hi.to(i32)[..., None], dds <= L2,
            dds <= L1)


def end_lanes(pm: torch.Tensor, bases: List[int], W: int):
    """The lane of each diagonal's last-row cell (i = len1; pairs 0..B-1)
    and last-column cell (j = len2; pairs B..2B-1), clamped into the window,
    and whether it lies inside the window: both (D+1, 2B)."""
    base64 = torch.tensor(bases, dtype=torch.int64, device=pm.device)[:, None]
    dds = torch.arange(len(bases), dtype=torch.int64, device=pm.device)[:, None]
    end_lane = torch.cat((pm[:, 0][None, :] - base64,
                          dds - pm[:, 1][None, :] - base64), dim=1)
    end_in = (end_lane >= 0) & (end_lane < W)
    return end_lane.clamp(0, W - 1), end_in


def stats_rows_plain(pool, pm, base, W, d_max, band, match=2, mismatch=-2,
                     gap_ext=1) -> torch.Tensor:
    """Plain PyTorch version of the stats DP: the same wavefront over (B, W)
    tensors, one Python step per anti-diagonal, the six fields stacked as
    (6, B, W) int32 per layer."""
    global PLAIN_LAUNCHES, PLAIN_PAIRS
    dev = pool.device
    i32, i64 = torch.int32, torch.int64
    B = pm.shape[0]
    NEG = int(NEG_INF)
    col = pm.to(i32).T[:, :, None]                       # (8, B, 1)
    len1, len2, gopen, kk, mid = col[0], col[1], col[2], col[3], col[4]
    mask = (torch.ones_like(kk) << kk) - 1
    lanes = torch.arange(W, dtype=i32, device=dev)[None, :]
    bases = base[: d_max + 1].tolist()
    hi = max(bases) + W

    s1p, s2r = padded_rows(pool, pm, d_max, hi)
    dds, i_lo, i_hi, top_ok, left_ok = interior_rows(pm, d_max, band)
    top_ok, left_ok = top_ok.to(i32), left_ok.to(i32)
    wc0 = torch.where(pm[:, 4][None, :] <= 0,
                      torch.clamp(dds - pm[:, 3][None, :] + 1, min=0), 0)
    bnd = torch.zeros((d_max + 1, 6, B), dtype=i32, device=dev)
    bnd[:, 3] = wc0
    bnd[:, 5] = dds
    end_lane, end_in = end_lanes(pm, bases, W)
    b2 = torch.arange(B, device=dev).repeat(2)
    end_cell = torch.zeros((d_max + 1, 6, 2 * B), dtype=i32, device=dev)
    end_valid = torch.zeros((d_max + 1, 2 * B), dtype=i32, device=dev)

    fill = torch.zeros((6, B, 2), dtype=i32, device=dev)
    fill[0] = NEG
    km1 = kk - 1
    neg = fill[..., :1].expand(6, B, W)
    hd1 = neg.clone()
    hd1[0, :, 0] = 0              # diagonal 0: only cell (0, 0), score 0
    hd2, ee, ff = neg, neg, neg

    for dd in range(1, d_max + 1):
        b0 = bases[dd]
        d1 = b0 - bases[dd - 1]
        d2 = b0 - bases[max(dd - 2, 0)]
        iv = b0 + lanes
        valid = ((iv >= i_lo[dd]) & (iv <= i_hi[dd])).to(i32)

        # E: gap in s1 (left), predecessor (i, j-1) on diagonal d-1
        hl, el = _shift(hd1, d1, fill), _shift(ee, d1, fill)
        e_open, e_ext = hl[0] - gopen, el[0] - gap_ext
        enew = _sel((e_open >= e_ext).to(i32), hl, el)
        enew[0] = torch.maximum(e_open, e_ext)
        _push(enew, None, km1, kk, mid, mask)

        # F: gap in s2 (up), predecessor (i-1, j) on diagonal d-1
        hu, fu = _shift(hd1, d1 - 1, fill), _shift(ff, d1 - 1, fill)
        f_open, f_ext = hu[0] - gopen, fu[0] - gap_ext
        fnew = _sel((f_open >= f_ext).to(i32), hu, fu)
        fnew[0] = torch.maximum(f_open, f_ext)
        _push(fnew, None, km1, kk, mid, mask)

        # diagonal: (i-1, j-1) on diagonal d-2 plus the substitution column
        s2o = d_max - dd + b0
        ismatch = (s1p[:, b0: b0 + W] == s2r[:, s2o: s2o + W]).to(i32)
        dnew = _shift(hd2, d2 - 1, fill).clone()
        dnew[0] += mismatch + ismatch * (match - mismatch)
        _push(dnew, ismatch, km1, kk, mid, mask)

        # H: the traceback's tie-break, diag > up > left
        h_no_e = torch.maximum(dnew[0], fnew[0])
        hnew = _sel((enew[0] > h_no_e).to(i32), enew,
                    _sel((fnew[0] > dnew[0]).to(i32), fnew, dnew))
        # boundary cells (0, d) in lane 0 when base is 0, and (d, 0) in lane
        # d - base: a path restarts there with i + j = d leading gap columns
        for lane, ok in ((0 if b0 == 0 else -1, top_ok[dd]),
                         (dd - b0, left_ok[dd])):
            if 0 <= lane < W:
                valid[:, lane] = ok
                hnew[:, :, lane] = _sel(ok, bnd[dd], hnew[:, :, lane])
        hnew[0] = _sel(valid, hnew[0], NEG)

        end_cell[dd] = hnew[:, b2, end_lane[dd]]
        end_valid[dd] = valid[b2, end_lane[dd]]
        hd2, hd1, ee, ff = hd1, hnew, enew, fnew

    # trackers [score, coord, hist, wsum, wcount, mcount, colcount, diagonal]:
    # a sequential ">=" running max from (NEG_INF, -1, 0, ...), i.e. the
    # latest diagonal among the cells of maximal score >= NEG_INF
    score = end_cell[1:, 0].to(i64)
    ok = (end_valid[1:] > 0) & end_in[1:] & (score >= NEG)
    score = torch.where(ok, score, torch.iinfo(i64).min)
    best = score.max(0).values
    pick = torch.where(ok & (score == best), dds[1:], 0).max(0).values
    cell = end_cell[pick, :, torch.arange(2 * B, device=dev)]     # (2B, 6)
    coord = pick - torch.cat((pm[:, 0], pm[:, 1]))
    trk = torch.cat((cell[:, :1], coord[:, None].to(i32), cell[:, 1:],
                     pick[:, None].to(i32)), dim=1)
    init = torch.tensor([NEG, -1, 0, 0, 0, 0, 0, 0], dtype=i32, device=dev)
    trk = torch.where(ok.any(0)[:, None], trk, init)
    with _COUNT_LOCK:
        PLAIN_LAUNCHES += 1
        PLAIN_PAIRS += B
    return torch.cat((trk[:B], trk[B:]), dim=1).contiguous()


# ---------------------------------------------------------------------------
# host side: window schedule, chunking, finalize
# ---------------------------------------------------------------------------

def _popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized 32-bit popcount (SWAR)."""
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


_SCHED_CACHE: dict = {}
_SCHED_LOCK = threading.Lock()


def _window_schedule(len1: np.ndarray, len2: np.ndarray,
                     n: int, m: int, band: int) -> Tuple[np.ndarray, int]:
    """Per-diagonal window origin ``base`` and width ``W`` covering every
    pair's banded cell set (plus the boundary rows/columns each pair's band
    touches).  base is non-decreasing with slope <= 1, so a predecessor
    sits 0 or 1 lanes over ({0..2} across two diagonals).

    Memoized on the (min/max length, bucket, band) envelope: the hull of
    the envelope's two extreme pairs contains every pair hull, so reusing
    it preserves coverage while collapsing the per-launch recompute."""
    key = (int(len1.min()), int(len1.max()), int(len2.min()),
           int(len2.max()), n, m, band)
    with _SCHED_LOCK:
        hit = _SCHED_CACHE.get(key)
    if hit is not None:
        return hit
    out = _window_schedule_raw(len1, len2, n, m, band, key)
    with _SCHED_LOCK:
        if len(_SCHED_CACHE) > 4096:
            _SCHED_CACHE.clear()
        _SCHED_CACHE[key] = out
    return out


def _window_schedule_raw(len1, len2, n, m, band, key) -> Tuple[np.ndarray, int]:
    # Envelope: the hull formulas below are monotone in n_b and in m_b, so
    # the four corner combinations of (min/max len1, min/max len2) bound
    # every pair pointwise per diagonal.  No dead-diagonal exclusion: a
    # corner whose matrix has ended keeps contributing its (clipped,
    # nondecreasing) hull values, which can only lower base / raise W —
    # both coverage-safe.  (An exclusion would be UNsafe: dropping a short
    # corner at large dd can raise the min above a live mid-length pair.)
    l1a, l1b = key[0], key[1]
    l2a, l2b = key[2], key[3]
    len1 = np.array([l1a, l1a, l1b, l1b], np.int64)
    len2 = np.array([l2a, l2b, l2a, l2b], np.int64)
    D = n + m
    dpad = -(-(D + 1) // 8) * 8
    if band <= 0:
        W = -(-(n + 1) // 128) * 128
        return np.zeros((1, dpad), np.int32), W
    dd = np.arange(D + 1, dtype=np.int64)[:, None]
    n_b = len1.astype(np.int64)[None, :]
    m_b = len2.astype(np.int64)[None, :]
    tot = n_b + m_b
    # interior band rows on diagonal dd (from the multiplicative band test)
    lo_int = -(-(np.maximum(dd - band, 0) * n_b) // tot)    # ceil
    hi_int = ((dd + band + 1) * n_b - 1) // tot
    lo_int = np.maximum(lo_int, np.maximum(1, dd - m_b))
    hi_int = np.minimum(hi_int, n_b)
    hi_int = np.maximum(hi_int, 0)
    # boundary i=0 (cell (0, dd)): consumed by in-band cells at i=1, which
    # exist only while dd <= band + len2/len1 (+ slack)
    lo = np.where(dd <= np.minimum(m_b, band + m_b // n_b + 2), 0, lo_int)
    # boundary j=0 (cell (dd, 0)): consumed by in-band cells at j=1, which
    # exist only while i <= (band+1)*len1/len2 (+ slack)
    hi = np.where(dd <= np.minimum(n_b, (band + 1) * n_b // m_b + 2),
                  np.minimum(dd, n_b), hi_int)
    hi = np.minimum(hi, np.minimum(dd, n_b))
    need_lo = np.minimum.reduce(np.clip(lo, 0, n), axis=1)
    need_hi = np.maximum.reduce(hi, axis=1)
    base = np.clip(need_lo, 0, n)
    # slope <= 1: cap upward jumps (a short pair leaving the hull can make
    # need_lo jump) by base[d] <- min_{e<=d}(need_lo[e] + (d - e)); lowering
    # a later base only widens coverage, and since need_lo is nondecreasing
    # the result stays nondecreasing (W is computed afterwards)
    idx = np.arange(base.size, dtype=np.int64)
    base = np.minimum.accumulate(base - idx) + idx
    W_need = int(np.max(np.maximum(need_hi - base, 0)) + 1)
    W = max(128, -(-W_need // 128) * 128)
    W = min(W, -(-(n + 1) // 128) * 128)
    if W >= n + 1:
        return np.zeros((1, dpad), np.int32), W  # window = full matrix
    out = np.zeros((1, dpad), np.int32)
    out[0, : D + 1] = base.astype(np.int32)
    return out, W


#: Pairs per launch (one thread block each); larger requests run as several
#: launches on one stream.  Kept from the reference, to be measured on the
#: card.
MAX_B = 4096


def _plan_chunks(seqs, rows1, rows2) -> List[List[int]]:
    """Split request indices into device chunks: bounded size and coarse
    length buckets (banded windows stay near 2*band wide when pair lengths
    are comparable).  Within a bucket, pairs are graded by total length
    DESCENDING, so pairs launched together end on similar diagonals."""
    order = sorted(
        range(len(rows1)),
        key=lambda i: (_bucket_width(seqs[rows1[i]].size),
                       _bucket_width(seqs[rows2[i]].size),
                       -(seqs[rows1[i]].size + seqs[rows2[i]].size)))
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


def stage_chunk(pool: SeqPool, seqs, r1, r2, gap_opens, ks, match_ids,
                band):
    """One chunk's DP inputs on the pool's device: the (B, 8) pair table,
    the window schedule ``base`` and its width ``W``, and ``d_max`` (the
    last diagonal any pair reaches); plus the host-side lengths."""
    B = len(r1)
    len1 = np.fromiter((seqs[r].size for r in r1), np.int64, count=B)
    len2 = np.fromiter((seqs[r].size for r in r2), np.int64, count=B)
    n = _bucket_width(int(len1.max()))
    m = _bucket_width(int(len2.max()))
    pm = np.zeros((B, 8), np.int64)
    pm[:, 0] = len1
    pm[:, 1] = len2
    pm[:, 2] = gap_opens
    pm[:, 3] = ks
    pm[:, 4] = match_ids
    pm[:, 5] = pool.offsets([seqs[r] for r in r1])
    pm[:, 6] = pool.offsets([seqs[r] for r in r2])
    base, W = _window_schedule(len1, len2, n, m, band)
    dev = pool.device
    return (torch.from_numpy(pm).to(dev), torch.from_numpy(base[0]).to(dev),
            W, int((len1 + len2).max()), len1, len2)


def _launch_chunk(pool: SeqPool, buf: torch.Tensor, seqs, r1, r2, gap_opens,
                  ks, match_ids, match, mismatch, gap_ext, band):
    """Run one chunk's DP on the pool's device (asynchronously on CUDA);
    ``buf`` is what ``pool.ensure`` returned for the chunk's rows."""
    pm, base, W, d_max, len1, len2 = stage_chunk(
        pool, seqs, r1, r2, gap_opens, ks, match_ids, band)
    best = stats_rows(buf, pm, base, W, d_max, band, match, mismatch,
                      gap_ext)
    return best, len1, len2, np.asarray(ks, np.int64), \
        np.asarray(match_ids, np.int64), band


def _gather_chunk(best_dev, len1, len2, karr, midarr, band):
    B = len1.size
    best = np.asarray(best_dev)[:B]

    use_row = best[:, 0] >= best[:, 8]
    side = np.where(use_row[:, None], best[:, 0:8], best[:, 8:16])
    if band > 0:
        # native banded endpoint scans fall back to the empty alignment
        # (H[n][0] = 0 / col_best init 0) when every banded endpoint is
        # negative; synthesize the same endpoint here
        neg = side[:, 0] < 0
        if neg.any():
            use_row = np.where(neg, True, use_row)
            empty = np.zeros_like(side)
            empty[:, 6] = len1                        # cc = i + j at (n, 0)
            empty[:, 4] = np.where(midarr <= 0,
                                   np.maximum(len1 - karr + 1, 0), 0)
            empty[:, 1] = 0
            side = np.where(neg[:, None], empty, side)
    end_i = np.where(use_row, len1, side[:, 1])
    end_j = np.where(use_row, side[:, 1], len2)
    hist = side[:, 2].astype(np.int64)
    wc = side[:, 4].astype(np.int64)
    mc = side[:, 5].astype(np.int64)
    cc = side[:, 6].astype(np.int64)

    # trailing terminal gaps: tail mismatch columns shift the window by t;
    # after t shifts the window holds the low (k - t) history bits.
    tail = (len1 - end_i) + (len2 - end_j)
    t_cap = int(min(tail.max(initial=0), karr.max(initial=0)))
    for t in range(1, t_cap + 1):
        active = (tail >= t) & (t <= karr)
        keep = np.maximum(karr - t, 0)
        ws_t = _popcount(hist & ((np.int64(1) << keep) - 1))
        hit = active & (cc + t >= karr) & (ws_t >= midarr)
        wc += hit.astype(np.int64)
    # columns shifted fully out of the window: wsum = 0
    extra = np.maximum(tail - karr, 0)
    wc += np.where(midarr <= 0, extra, 0)

    total = cc + tail
    ident = mc / np.maximum(total, 1)
    ok = total >= karr
    r1 = np.where(ok, wc / len1, 0.0)
    r2 = np.where(ok, wc / len2, 0.0)
    return [(float(r1[i]), float(r2[i]), float(ident[i])) for i in range(B)]


def sg_stats_pool_torch(
    seqs: Sequence[np.ndarray],
    rows1: Sequence[int],
    rows2: Sequence[int],
    gap_opens: Sequence[int],
    ks: Sequence[int],
    match_ids: Sequence[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    band: int = 0,
    device: Optional[torch.device] = None,
) -> List[Tuple[float, float, float]]:
    """Per pair ``(aligned_ratio_s1, aligned_ratio_s2, identity)`` of
    ``seqs[rows1[p]]`` against ``seqs[rows2[p]]``, computed on ``device``
    (a CUDA device runs the kernel, the CPU the plain version; default:
    ``stats_device(stats_backend_default())``, so ``cuda:0`` unless the
    caller asks for the CPU).  Every chunk is launched on the current
    stream; then all results move to the host in one step."""
    n_pairs = len(rows1)
    if n_pairs == 0:
        return []
    if not all(1 <= k <= MAX_K for k in ks):
        raise ValueError(f"stats DP requires 1 <= k <= {MAX_K}")
    if device is None:
        device = stats_device(stats_backend_default())
    with span("stats.stage"):
        pool = device_pool(torch.device(device))
        buf = pool.ensure([seqs[r] for r in
                           dict.fromkeys(list(rows1) + list(rows2))])
        chunks = _plan_chunks(seqs, rows1, rows2)
        futures = []
        for sl in chunks:
            futures.append(_launch_chunk(
                pool, buf, seqs, [rows1[i] for i in sl],
                [rows2[i] for i in sl], [gap_opens[i] for i in sl],
                [ks[i] for i in sl], [match_ids[i] for i in sl], match,
                mismatch, gap_ext, band))
    with span("stats.wait"):
        host = torch.cat([f[0] for f in futures]).cpu().numpy()
    out: List[Optional[Tuple[float, float, float]]] = [None] * n_pairs
    at = 0
    with span("stats.gather"):
        for sl, fut in zip(chunks, futures):
            res = _gather_chunk(host[at: at + len(sl)], *fut[1:])
            at += len(sl)
            for i, r in zip(sl, res):
                out[i] = r
    return out  # type: ignore[return-value]


def pair_rows(pairs) -> Tuple[List[np.ndarray], List[int], List[int]]:
    """Explicit pairs as ``(seqs, rows1, rows2)``: each distinct array
    object becomes one row."""
    seqs: List[np.ndarray] = []
    row_of: dict = {}
    rows1, rows2 = [], []
    for a, b in pairs:
        for arr, rows in ((a, rows1), (b, rows2)):
            key = id(arr)
            r = row_of.get(key)
            if r is None:
                r = len(seqs)
                row_of[key] = r
                seqs.append(arr)
            rows.append(r)
    return seqs, rows1, rows2


def sg_stats_batch_torch(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    gap_opens: Sequence[int],
    ks: Sequence[int],
    match_ids: Sequence[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    band: int = 0,
    device: Optional[torch.device] = None,
) -> List[Tuple[float, float, float]]:
    """:func:`sg_stats_pool_torch` over explicit pairs; repeated array
    objects share one pool row.  ``device=None``: the configured backend's
    device, as there."""
    if not pairs:
        return []
    seqs, rows1, rows2 = pair_rows(pairs)
    return sg_stats_pool_torch(
        seqs, rows1, rows2, gap_opens, ks, match_ids,
        match=match, mismatch=mismatch, gap_ext=gap_ext, band=band,
        device=device)


def block_stats_torch(pairs, gap_opens, ks, match_ids, band=0, device=None):
    """(aligned_ratio, target_ratio) per pair — counterpart of
    native.block_stats_native (``device=None``: the configured backend's
    device)."""
    out = sg_stats_batch_torch(pairs, gap_opens, ks, match_ids, band=band,
                               device=device)
    return [(r1, r2) for r1, r2, _ in out]


def identity_torch(pairs, gap_opens, match=2, mismatch=-2, gap_ext=1,
                   band=0, device=None):
    """Column identity per pair — counterpart of native.identity_native
    (consensus.py:129-145 alignment parameters; ``device=None``: the
    configured backend's device)."""
    out = sg_stats_batch_torch(
        pairs, gap_opens, [1] * len(pairs), [1] * len(pairs),
        match=match, mismatch=mismatch, gap_ext=gap_ext, band=band,
        device=device)
    return [ident for _, _, ident in out]
