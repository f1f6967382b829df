"""The polish pileup accumulated where the moves DP left its paths.

:func:`accumulate` takes the launched chunks of
:func:`ngspeciesid_tpu_torch.ops.align_moves.launch_moves_pool` (as
``align_moves.sg_moves_pool_torch``'s result holds them; reads
aligned against a center, or against their windows of it) and returns the
pileup's column counts and insertion events, as ``ops/poa._walk`` would
accumulate them from the full-span move arrays, without building those:

* :func:`walk_rows`, once a chunk: each pair's traced path (``best`` and
  ``ops``) trimmed as ``poa.trim_to_aligned`` trims, each committed center
  column's symbol and weight into a (reads x L) matrix, the read's coverage
  span, and its insertion runs as events (pos, r_lo, r_hi) in the walk's
  order;
* :func:`reduce_rows`, once a call: votes, quality-weighted votes and
  coverage per column, added in read order (the walk's order, so the
  float64 sums are the same bits), and every read's events packed in read
  order as (pos, read, r_lo, r_hi).

CUDA tensors run ``csrc/pileup_kernel.cu``, CPU tensors the plain PyTorch
versions (:func:`walk_rows_plain`, :func:`reduce_rows_plain`).  The event
bytes and weights, and their fold into dicts, stay on the host
(``ops/poa.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.phred import PHRED_TO_P_CAPPED
from .align import DIAG, LEFT, NEG_INF, UP

#: Kernel launches (walks and reductions) and reads walked by the kernel.
LAUNCHES = 0
READS = 0
#: The same for the plain PyTorch versions (CPU tensors).
PLAIN_LAUNCHES = 0
PLAIN_READS = 0
_COUNT_LOCK = threading.Lock()

#: Symbols of the pileup matrix: A C G T as columns 0-3, a gap 4, and a base
#: that votes nothing (N or any byte but A, C, G, T) 5.
GAP, NO_VOTE = 4, 5
_SYMBOL = torch.full((256,), NO_VOTE, dtype=torch.uint8)
for _i, _b in enumerate(b"ACGT"):
    _SYMBOL[_b] = _i

_TABLES: Dict[torch.device, torch.Tensor] = {}
_TABLES_LOCK = threading.Lock()


def reset_counts() -> None:
    global LAUNCHES, READS, PLAIN_LAUNCHES, PLAIN_READS
    with _COUNT_LOCK:
        LAUNCHES = READS = PLAIN_LAUNCHES = PLAIN_READS = 0


def _weight_table(device: torch.device) -> torch.Tensor:
    """PHRED_TO_P_CAPPED (float64, by ASCII code) on ``device``, copied
    there once."""
    with _TABLES_LOCK:
        t = _TABLES.get(device)
        if t is None:
            t = _TABLES[device] = torch.from_numpy(PHRED_TO_P_CAPPED).to(device)
        return t


# ---------------------------------------------------------------------------
# one call's tensors
# ---------------------------------------------------------------------------

class CallTensors(NamedTuple):
    """The inputs and outputs of one call's launches (:func:`walk_rows`,
    :func:`reduce_rows`) on its device; ``idx`` holds the chunks' read
    indices in launch order."""
    rinfo: torch.Tensor
    idx: torch.Tensor
    quals: torch.Tensor
    wtab: torch.Tensor
    sym: torch.Tensor
    wt: torch.Tensor
    spans: torch.Tensor
    ev: torch.Tensor
    nev: torch.Tensor
    stats: torch.Tensor
    evout: torch.Tensor
    has_quals: bool


def stage_call(L: int, reads: Sequence[np.ndarray],
               quals: Optional[Sequence[np.ndarray]],
               windows: Optional[np.ndarray], chunks: List,
               dev: torch.device) -> CallTensors:
    """One call's tensors on ``dev``: its per-read inputs in one upload
    (asynchronous from pinned memory to a CUDA device) and its outputs,
    allocated.  Raises where the walk would: a quality byte outside
    PHRED_TO_P_CAPPED, or fewer qualities than bases."""
    R = len(reads)
    lens = np.fromiter((x.size for x in reads), np.int64, count=R)
    has_quals = quals is not None
    if has_quals:
        qlens = np.fromiter((x.size for x in quals), np.int64, count=R)
        if (qlens < lens).any():
            raise ValueError("every read needs a quality per base")
        qcat = np.concatenate(quals)
        if qcat.size and int(qcat.max()) >= PHRED_TO_P_CAPPED.size:
            raise IndexError("quality byte outside PHRED_TO_P_CAPPED")
        qoff = np.cumsum(qlens) - qlens
    else:
        qcat = np.zeros(1, np.uint8)
        qoff = np.zeros(R, np.int64)
    # per read (window start, quality offset), then the chunks' read
    # indices, then the qualities
    ints = np.empty(3 * R, np.int64)
    ints[0: 2 * R: 2] = windows[:, 0] if windows is not None else 0
    ints[1: 2 * R: 2] = qoff
    ints[2 * R:] = np.fromiter((i for ch in chunks for i in ch.idx),
                               np.int64, count=R)
    host = np.empty(ints.nbytes + qcat.size, np.uint8)
    host[: ints.nbytes] = ints.view(np.uint8)
    host[ints.nbytes:] = qcat
    blob = torch.from_numpy(host)
    if dev.type == "cuda":
        blob = blob.pin_memory().to(dev, non_blocking=True)
    ints_dev = blob[: ints.nbytes].view(torch.int64)
    cap = int(lens.max()) + 2
    return CallTensors(
        rinfo=ints_dev[: 2 * R].view(R, 2), idx=ints_dev[2 * R:],
        quals=blob[ints.nbytes:], wtab=_weight_table(dev),
        sym=torch.empty((R, L), dtype=torch.uint8, device=dev),
        wt=torch.empty((R, L), dtype=torch.float64, device=dev),
        spans=torch.empty((R, 2), dtype=torch.int32, device=dev),
        ev=torch.empty((R, cap, 3), dtype=torch.int32, device=dev),
        nev=torch.empty(R, dtype=torch.int32, device=dev),
        stats=torch.empty(11 * L + 2, dtype=torch.float64, device=dev),
        evout=torch.empty((R * cap, 4), dtype=torch.int32, device=dev),
        has_quals=has_quals)


# ---------------------------------------------------------------------------
# the walk of one chunk: kernel wrapper and its plain PyTorch version
# ---------------------------------------------------------------------------

def walk_rows(ops, best, pm, pool, idx, c: CallTensors) -> None:
    """Walk the B pairs of one moves chunk into the call's tensors ``c``.

    ops (B, dpad) uint8 and best (B, 16) int32: the chunk's traced paths
    (``align_moves.moves_rows``); pm (B, 8) int64: its pair table (len1 the
    window's length, len2 the read's, the read's offset into ``pool`` at
    column 6); idx (B,) int64: each pair's read index.  Writes, for the
    read r of each pair: ``c.sym[r]`` (R, L) uint8 and ``c.wt[r]`` (R, L)
    float64 at the columns it commits (inside its span; elsewhere left as
    they were), ``c.spans[r]`` = its coverage span [lo, hi] ((0, -1) where
    it votes nothing), ``c.ev[r, :c.nev[r]]`` = its events (pos, r_lo,
    r_hi) and ``c.nev[r]``.  CUDA tensors launch the kernel on the current
    stream, CPU tensors run the plain version."""
    if ops.device.type == "cuda":
        _walk_rows_cuda(ops, best, pm, pool, idx, c)
    elif ops.device.type == "cpu":
        walk_rows_plain(ops, best, pm, pool, idx, c)
    else:
        raise ValueError(f"no pileup walk for device {ops.device}")


def _check(tensors, dtypes) -> None:
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"pileup kernel: expected a contiguous {dt} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")


def _walk_rows_cuda(ops, best, pm, pool, idx, c: CallTensors) -> None:
    global LAUNCHES, READS
    from . import cuda_lib

    _check((ops, best, pm, pool, idx, c.rinfo, c.quals, c.wtab, c.sym, c.wt,
            c.spans, c.ev, c.nev),
           (torch.uint8, torch.int32, torch.int64, torch.uint8, torch.int64,
            torch.int64, torch.uint8, torch.float64, torch.uint8,
            torch.float64, torch.int32, torch.int32, torch.int32))
    lib = cuda_lib.load()
    B = ops.shape[0]
    dev = ops.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ngsid_pileup_walk_launch(
            ops.data_ptr(), best.data_ptr(), pm.data_ptr(), pool.data_ptr(),
            idx.data_ptr(), c.rinfo.data_ptr(), c.quals.data_ptr(),
            c.wtab.data_ptr(), c.sym.data_ptr(), c.wt.data_ptr(),
            c.spans.data_ptr(), c.ev.data_ptr(), c.nev.data_ptr(), B,
            ops.shape[1], c.sym.shape[1], c.ev.shape[1], int(c.has_quals),
            stream)
    cuda_lib.check(err, "pileup walk launch")
    with _COUNT_LOCK:
        LAUNCHES += 1
        READS += B


def walk_rows_plain(ops, best, pm, pool, idx, c: CallTensors) -> None:
    """Plain PyTorch version of the walk, vectorised over the chunk: the
    same outputs as the kernel, counted as a plain launch."""
    global PLAIN_LAUNCHES, PLAIN_READS
    sym, wt, ev = c.sym, c.wt, c.ev
    L = sym.shape[1]
    i64 = torch.int64
    B, D = ops.shape
    op = ops.to(i64)
    isd, isu, isl = op == DIAG, op == UP, op == LEFT
    nd, nu, nl = isd.sum(1), isu.sum(1), isl.sum(1)
    n, m = pm[:, 0], pm[:, 1]
    b0, b8 = best[:, 0].to(i64), best[:, 8].to(i64)
    reach = (b0 > NEG_INF // 2) | (b8 > NEG_INF // 2)
    use_row = b0 >= b8
    end_i = torch.where(use_row, n, best[:, 9].to(i64))
    end_j = torch.where(use_row, best[:, 1].to(i64), m)
    vote = reach & (nd > 0)
    d = torch.arange(D, dtype=i64)
    d0 = torch.where(isd, d, D).min(1).values[:, None]
    d1 = torch.where(isd, d, -1).max(1).values[:, None]
    # _reconstruct's terminal gaps plus trim_to_aligned's head
    head_part = d < d0
    ci0 = end_i - nd - nu + (isu & head_part).sum(1)
    ri0 = end_j - nd - nl + (isl & head_part).sum(1)
    core = (d >= d0) & (d <= d1) & vote[:, None]
    commit = (isd | isu) & core
    reads = (isd | isl) & core
    ci = ci0[:, None] + commit.cumsum(1) - commit.to(i64)   # exclusive
    ri = ri0[:, None] + reads.cumsum(1) - reads.to(i64)
    r = idx
    wl, qoff = c.rinfo[r, 0], c.rinfo[r, 1]

    pb, pd = (isd & core).nonzero(as_tuple=True)
    rr = ri[pb, pd]
    col = wl[pb] + ci[pb, pd]
    sym[r[pb], col] = _SYMBOL[pool[pm[pb, 6] + rr].to(i64)]
    if c.has_quals:
        wt[r[pb], col] = 1.0 - c.wtab[c.quals[qoff[pb] + rr].to(i64)]
    else:
        wt[r[pb], col] = 1.0
    ub, ud = (isu & core).nonzero(as_tuple=True)
    sym[r[ub], wl[ub] + ci[ub, ud]] = GAP

    left = isl & core
    opens = left & ~F.pad(left[:, :-1], (1, 0))
    closes = left & ~F.pad(left[:, 1:], (0, 1))
    head = vote & (wl == 0) & (ci0 == 0) & (ri0 > 0)
    runs = opens.sum(1)
    ob, od = opens.nonzero(as_tuple=True)
    cb, cd = closes.nonzero(as_tuple=True)   # row-major: k-th close, k-th run
    k = head[ob].to(i64) + (opens.cumsum(1) - 1)[ob, od]
    ev[r[ob], k] = torch.stack(
        (wl[ob] + ci[ob, od], ri[ob, od], ri[cb, cd] + 1), 1).to(torch.int32)
    ci_end = ci0 + commit.sum(1)
    r_done = ri0 + reads.sum(1)
    tail = vote & (wl + n == L) & (ci_end == n) & (r_done < m)
    zero = torch.zeros_like(ri0)
    hb = head.nonzero(as_tuple=True)[0]
    ev[r[hb], 0] = torch.stack((zero[hb], zero[hb], ri0[hb]), 1).to(torch.int32)
    tb = tail.nonzero(as_tuple=True)[0]
    ev[r[tb], (head.to(i64) + runs)[tb]] = torch.stack(
        (torch.full_like(r_done[tb], L), r_done[tb], m[tb]), 1).to(torch.int32)
    c.nev[r] = torch.where(vote, head.to(i64) + runs + tail.to(i64),
                           0).to(torch.int32)
    c.spans[r] = torch.stack((torch.where(vote, wl + ci0, 0),
                            torch.where(vote, wl + ci_end, -1)),
                           1).to(torch.int32)
    with _COUNT_LOCK:
        PLAIN_LAUNCHES += 1
        PLAIN_READS += B


# ---------------------------------------------------------------------------
# the reduction of one call: kernel wrapper and its plain PyTorch version
# ---------------------------------------------------------------------------

def reduce_rows(c: CallTensors) -> None:
    """Add the walked reads of a call in read order: ``c.stats`` ((11 L +
    2,) float64) receives votes (L, 5), quality-weighted votes (L, 5),
    coverage (L + 1) and, last, the number of events E; ``c.evout[:E]``
    every read's events in read order as (pos, read, r_lo, r_hi).  CUDA
    tensors launch the kernel on the current stream, CPU tensors run the
    plain version."""
    if c.sym.device.type == "cuda":
        _reduce_rows_cuda(c)
    elif c.sym.device.type == "cpu":
        reduce_rows_plain(c)
    else:
        raise ValueError(f"no pileup reduction for device {c.sym.device}")


def _reduce_rows_cuda(c: CallTensors) -> None:
    global LAUNCHES
    from . import cuda_lib

    _check((c.sym, c.wt, c.spans, c.ev, c.nev, c.stats, c.evout),
           (torch.uint8, torch.float64, torch.int32, torch.int32, torch.int32,
            torch.float64, torch.int32))
    lib = cuda_lib.load()
    dev = c.sym.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ngsid_pileup_reduce_launch(
            c.sym.data_ptr(), c.wt.data_ptr(), c.spans.data_ptr(),
            c.ev.data_ptr(), c.nev.data_ptr(), c.stats.data_ptr(),
            c.evout.data_ptr(), c.sym.shape[0], c.sym.shape[1],
            c.ev.shape[1], stream)
    cuda_lib.check(err, "pileup reduction launch")
    with _COUNT_LOCK:
        LAUNCHES += 1


def reduce_rows_plain(c: CallTensors) -> None:
    """Plain PyTorch version of the reduction: unit votes and coverage are
    whole counts, summed at once; the weighted votes are added one read at
    a time, in read order."""
    global PLAIN_LAUNCHES
    sym, spans, ev, stats = c.sym, c.spans, c.ev, c.stats
    R, L = sym.shape
    p = torch.arange(L + 1)
    lo, hi = spans[:, :1].long(), spans[:, 1:].long()
    covered = (p >= lo) & (p <= hi)                       # (R, L + 1)
    voted = covered[:, :L] & (p[:L] < hi)
    s = torch.where(voted, sym.long(), NO_VOTE)
    one = F.one_hot(s, NO_VOTE + 1)[..., :NO_VOTE].bool()   # (R, L, 5)
    w = torch.where(s == GAP, 1.0, torch.where(voted, c.wt, 0.0))
    add = torch.where(one, w[..., None], 0.0)
    qv = torch.zeros((L, 5), dtype=torch.float64)
    for r in range(R):
        qv += add[r]
    stats[: 5 * L] = one.sum(0).double().reshape(-1)
    stats[5 * L: 10 * L] = qv.reshape(-1)
    stats[10 * L: 11 * L + 1] = covered.sum(0).double()
    counts = c.nev.long()
    rows, k = (torch.arange(ev.shape[1]) < counts[:, None]).nonzero(
        as_tuple=True)
    e = ev[rows, k]
    c.evout[: rows.numel()] = torch.stack(
        (e[:, 0], rows.to(torch.int32), e[:, 1], e[:, 2]), 1)
    stats[11 * L + 1] = rows.numel()
    with _COUNT_LOCK:
        PLAIN_LAUNCHES += 1


# ---------------------------------------------------------------------------
# one call
# ---------------------------------------------------------------------------

def launch(pool: torch.Tensor, chunks: List, c: CallTensors) -> None:
    """Every launch of one call: each chunk's walk, in the chunks' order
    (``c.idx``), then the reduction."""
    at = 0
    for ch in chunks:
        B = len(ch.idx)
        walk_rows(ch.ops, ch.best, ch.pm, pool, c.idx[at: at + B], c)
        at += B
    reduce_rows(c)


def accumulate(L: int, reads: Sequence[np.ndarray],
               quals: Optional[Sequence[np.ndarray]],
               windows: Optional[np.ndarray], pool: torch.Tensor,
               chunks: List) -> Tuple[np.ndarray, np.ndarray]:
    """The pileup of ``reads`` against a center of length L from the
    launched moves chunks of their pairs (``align_moves.MovesChunk``, each
    pair's request index its read's index) and the pool tensor they read:
    ``stats`` ((11 L + 2,) float64, as :func:`reduce_rows` fills it) and the
    events ((E, 4) int32: pos, read, r_lo, r_hi, in the walk's order).  On
    a CUDA pool every launch is queued on the current stream after the
    chunks' moves kernels, and the results cross to the host in two
    copies; on the CPU the plain versions run."""
    c = stage_call(L, reads, quals, windows, chunks, pool.device)
    launch(pool, chunks, c)
    stats = c.stats.cpu().numpy()
    return stats, c.evout[: int(stats[-1])].cpu().numpy()


def event_arrays(reads: Sequence[np.ndarray],
                 quals: Optional[Sequence[np.ndarray]], events: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The events of :func:`accumulate` as ``poa`` folds them: positions,
    weights, lengths and the inserted bytes concatenated.  A weight is the
    walk's ``w[r_lo:r_hi].sum() / (r_hi - r_lo)``: the runs of one length
    are gathered into rows and summed with numpy's own row sum, which adds
    a row as it adds the slice (tests/test_torch_pileup.py holds the two
    equal); 1 without qualities."""
    pos = events[:, 0].astype(np.int64)
    rd = events[:, 1].astype(np.int64)
    r_lo = events[:, 2].astype(np.int64)
    ln = events[:, 3].astype(np.int64) - r_lo
    total = int(ln.sum())
    off = np.cumsum(ln) - ln
    lens = np.fromiter((x.size for x in reads), np.int64, count=len(reads))
    starts = (np.cumsum(lens) - lens)[rd] + r_lo
    gather = np.repeat(starts - off, ln) + np.arange(total)
    ev_bytes = np.concatenate(reads)[gather] if total else np.zeros(0, np.uint8)
    if quals is None:
        return pos, np.ones(pos.size), ln, ev_bytes
    qlens = np.fromiter((x.size for x in quals), np.int64, count=len(quals))
    qstarts = (np.cumsum(qlens) - qlens)[rd] + r_lo
    qcat = np.concatenate(quals)
    sums = np.empty(pos.size)
    for n in np.unique(ln).tolist():
        sel = np.flatnonzero(ln == n)
        q = qcat[qstarts[sel, None] + np.arange(n)]
        sums[sel] = (1.0 - PHRED_TO_P_CAPPED[q]).sum(axis=1)
    return pos, sums / ln, ln, ev_bytes
