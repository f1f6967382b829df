"""The plain reference of the stats and moves DPs, frozen.

A copy of the plain PyTorch wavefronts that the port keeps beside its CUDA
kernels (``ngspeciesid_tpu_torch/ops/align_stats.py``: ``stats_rows_plain``
and its helpers, the window schedule, the chunk plan and the host finalize;
``ops/align_moves.py``: ``moves_plain``, ``_walk_plain``, ``_plan`` and
``_reconstruct``; ``ops/align.py``: ``_bucket_width``), taken as they stand
and imported from nowhere: the benchmark judges the kernels against this
copy, so a later change to the program cannot move the yardstick.  Only the
launch counters are gone.  Out-of-band H is unreachable and E and F run free
inside a chunk's window, so a pair's result depends on its chunk: the
functions at the end rebuild a call's chunks with the same plan, as the
program does, from the call's own inputs.

It runs on whatever device its tensors are on: the check runs it on the
card after the measured window, one Python step per anti-diagonal.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

NEG_INF = np.int32(-(2**30))
DIAG, UP, LEFT = 1, 2, 3
#: Pairs per chunk at most, as the program chunks them.
STATS_MAX_B = 4096
MOVES_MAX_B = 512


def _bucket_width(x: int) -> int:
    """Coarse length bucket (64, 128, ..., 1024, then +512 steps): the stats
    DP groups pairs by it (``align_stats._plan_chunks``)."""
    w = 64
    while w < x:
        w = w * 2 if w < 1024 else w + 512
    return w


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
    return torch.cat((trk[:B], trk[B:]), dim=1).contiguous()


def _shift_each(x: torch.Tensor, off: torch.Tensor, lanes: torch.Tensor,
                width: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
    """``_shift`` with an offset and a window width per pair: out[..., b, l]
    = x[..., b, l + off[b]] where 0 <= l + off[b] < width[b], else ``fill``
    (one value per leading field)."""
    idx = lanes + off[:, None]
    inside = (idx >= 0) & (idx < width[:, None])
    got = x.gather(-1, idx.clamp(0, x.shape[-1] - 1).expand(x.shape))
    return torch.where(inside, got, fill)


def stats_rows_each(pool, pm, bases, widths, d_maxes, band, match=2,
                    mismatch=-2, gap_ext=1) -> torch.Tensor:
    """``stats_rows_plain`` over pairs of many chunks at once: pair b runs
    in its own chunk's window, ``bases[:, b]`` ((D+1, B) int64, D the
    largest last diagonal) of width ``widths[b]`` up to its own last
    diagonal ``d_maxes[b]``.  Each pair's row equals the one
    ``stats_rows_plain`` gives it in its chunk: lanes past a pair's width
    are never read, and its trackers end at its own last diagonal."""
    dev = pool.device
    i32, i64 = torch.int32, torch.int64
    B = pm.shape[0]
    NEG = int(NEG_INF)
    d_max = int(d_maxes.max())
    W = int(widths.max())
    col = pm.to(i32).T[:, :, None]                       # (8, B, 1)
    len1, len2, gopen, kk, mid = col[0], col[1], col[2], col[3], col[4]
    mask = (torch.ones_like(kk) << kk) - 1
    lanes = torch.arange(W, dtype=i64, device=dev)[None, :]
    hi = int(bases.max()) + W

    s1p, s2r = padded_rows(pool, pm, d_max, hi)
    dds, i_lo, i_hi, top_ok, left_ok = interior_rows(pm, d_max, band)
    top_ok, left_ok = top_ok.to(i32), left_ok.to(i32)
    wc0 = torch.where(pm[:, 4][None, :] <= 0,
                      torch.clamp(dds - pm[:, 3][None, :] + 1, min=0), 0)
    bnd = torch.zeros((d_max + 1, 6, B), dtype=i32, device=dev)
    bnd[:, 3] = wc0
    bnd[:, 5] = dds
    base2 = torch.cat((bases, bases), dim=1)
    end_lane = torch.cat((pm[:, 0][None, :].expand(d_max + 1, B),
                          dds - pm[:, 1][None, :]), dim=1) - base2
    w2 = widths.repeat(2)[None, :]
    end_in = (end_lane >= 0) & (end_lane < w2)
    end_lane = torch.minimum(end_lane.clamp(min=0), w2 - 1)
    b2 = torch.arange(B, device=dev).repeat(2)
    end_cell = torch.zeros((d_max + 1, 6, 2 * B), dtype=i32, device=dev)
    end_valid = torch.zeros((d_max + 1, 2 * B), dtype=i32, device=dev)

    fill = torch.zeros((6, 1, 1), dtype=i32, device=dev)
    fill[0] = NEG
    km1 = kk - 1
    neg = fill.expand(6, B, W)
    hd1 = neg.clone()
    hd1[0, :, 0] = 0              # diagonal 0: only cell (0, 0), score 0
    hd2, ee, ff = neg, neg, neg

    for dd in range(1, d_max + 1):
        b0 = bases[dd]
        d1 = b0 - bases[dd - 1]
        d2 = b0 - bases[max(dd - 2, 0)]
        iv = b0[:, None] + lanes
        valid = ((iv >= i_lo[dd]) & (iv <= i_hi[dd])).to(i32)

        hl = _shift_each(hd1, d1, lanes, widths, fill)
        el = _shift_each(ee, d1, lanes, widths, fill)
        e_open, e_ext = hl[0] - gopen, el[0] - gap_ext
        enew = _sel((e_open >= e_ext).to(i32), hl, el)
        enew[0] = torch.maximum(e_open, e_ext)
        _push(enew, None, km1, kk, mid, mask)

        hu = _shift_each(hd1, d1 - 1, lanes, widths, fill)
        fu = _shift_each(ff, d1 - 1, lanes, widths, fill)
        f_open, f_ext = hu[0] - gopen, fu[0] - gap_ext
        fnew = _sel((f_open >= f_ext).to(i32), hu, fu)
        fnew[0] = torch.maximum(f_open, f_ext)
        _push(fnew, None, km1, kk, mid, mask)

        s2o = (d_max - dd + b0)[:, None] + lanes
        ismatch = (s1p.gather(1, iv.clamp(max=s1p.shape[1] - 1))
                   == s2r.gather(1, s2o.clamp(max=s2r.shape[1] - 1))).to(i32)
        dnew = _shift_each(hd2, d2 - 1, lanes, widths, fill).clone()
        dnew[0] += mismatch + ismatch * (match - mismatch)
        _push(dnew, ismatch, km1, kk, mid, mask)

        h_no_e = torch.maximum(dnew[0], fnew[0])
        hnew = _sel((enew[0] > h_no_e).to(i32), enew,
                    _sel((fnew[0] > dnew[0]).to(i32), fnew, dnew))
        for lane, ok in ((torch.where(b0 == 0, 0, -1), top_ok[dd]),
                         (dd - b0, left_ok[dd])):
            at = ((lanes == lane[:, None]) & (lane >= 0)[:, None]
                  & (lane < widths)[:, None])
            valid = torch.where(at, ok[:, None], valid)
            hnew = torch.where(at & (ok[:, None] > 0), bnd[dd][:, :, None],
                               hnew)
        hnew[0] = _sel(valid, hnew[0], NEG)

        end_cell[dd] = hnew[:, b2, end_lane[dd]]
        end_valid[dd] = valid[b2, end_lane[dd]]
        hd2, hd1, ee, ff = hd1, hnew, enew, fnew

    score = end_cell[1:, 0].to(i64)
    mine = dds[1:] <= d_maxes.repeat(2)[None, :]
    ok = (end_valid[1:] > 0) & end_in[1:] & (score >= NEG) & mine
    score = torch.where(ok, score, torch.iinfo(i64).min)
    best = score.max(0).values
    pick = torch.where(ok & (score == best), dds[1:], 0).max(0).values
    cell = end_cell[pick, :, torch.arange(2 * B, device=dev)]     # (2B, 6)
    coord = pick - torch.cat((pm[:, 0], pm[:, 1]))
    trk = torch.cat((cell[:, :1], coord[:, None].to(i32), cell[:, 1:],
                     pick[:, None].to(i32)), dim=1)
    init = torch.tensor([NEG, -1, 0, 0, 0, 0, 0, 0], dtype=i32, device=dev)
    trk = torch.where(ok.any(0)[:, None], trk, init)
    return torch.cat((trk[:B], trk[B:]), dim=1).contiguous()


def _popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized 32-bit popcount (SWAR)."""
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


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
        if cur and (key != cur_key or len(cur) >= STATS_MAX_B):
            chunks.append(cur)
            cur = []
        cur_key = key
        cur.append(i)
    if cur:
        chunks.append(cur)
    return chunks


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


def _plan_moves(seqs, rows1, rows2) -> List[List[int]]:
    """Split request indices into chunks of at most MOVES_MAX_B pairs sharing one
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
        if cur and (key != cur_key or len(cur) >= MOVES_MAX_B):
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



def _stage(buf_off, seqs, r1, r2, gap_opens, ks, match_ids, band, dev):
    """A chunk's pair table, window schedule, width, last diagonal and
    lengths (``stage_chunk`` of the program, over this module's pool)."""
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
    pm[:, 5] = [buf_off[r] for r in r1]
    pm[:, 6] = [buf_off[r] for r in r2]
    key = (int(len1.min()), int(len1.max()), int(len2.min()),
           int(len2.max()), n, m, band)
    base, W = _window_schedule_raw(len1, len2, n, m, band, key)
    return (torch.from_numpy(pm).to(dev), torch.from_numpy(base[0]).to(dev),
            W, int((len1 + len2).max()), len1, len2)


def _pool(seqs, rows, dev):
    """The rows' bytes on ``dev`` and each row's offset in them."""
    rows = list(dict.fromkeys(rows))
    off, at = {}, 0
    for r in rows:
        off[r] = at
        at += seqs[r].size
    flat = np.concatenate([seqs[r] for r in rows]) if rows else \
        np.zeros(1, np.uint8)
    return torch.from_numpy(np.ascontiguousarray(flat, np.uint8)).to(dev), off


def stats_call(seqs: Sequence[np.ndarray], rows1, rows2, gap_opens, ks,
               match_ids, match=2, mismatch=-2, gap_ext=1, band=0,
               device="cpu") -> List[Tuple[float, float, float]]:
    """``(aligned_ratio_s1, aligned_ratio_s2, identity)`` per pair, as the
    program's ``sg_stats_pool_torch`` returns them for the same call."""
    if not len(rows1):
        return []
    dev = torch.device(device)
    buf, off = _pool(seqs, list(rows1) + list(rows2), dev)
    out = [None] * len(rows1)
    for sl in _plan_chunks(seqs, rows1, rows2):
        pm, base, W, d_max, len1, len2 = _stage(
            off, seqs, [rows1[i] for i in sl], [rows2[i] for i in sl],
            [gap_opens[i] for i in sl], [ks[i] for i in sl],
            [match_ids[i] for i in sl], band, dev)
        best = stats_rows_plain(buf, pm, base, W, d_max, band, match,
                                mismatch, gap_ext).cpu().numpy()
        res = _gather_chunk(best, len1, len2,
                            np.asarray([ks[i] for i in sl], np.int64),
                            np.asarray([match_ids[i] for i in sl], np.int64),
                            band)
        for i, r in zip(sl, res):
            out[i] = r
    return out


def moves_call(seqs: Sequence[np.ndarray], rows1, rows2, gap_opens,
               match=2, mismatch=-2, gap_ext=1, band=0,
               device="cpu") -> List[np.ndarray]:
    """Each pair's full-span move array, as the program's
    ``sg_moves_pool_torch`` returns it for the same call."""
    if not len(rows1):
        return []
    dev = torch.device(device)
    buf, off = _pool(seqs, list(rows1) + list(rows2), dev)
    out = [None] * len(rows1)
    for sl in _plan_moves(seqs, rows1, rows2):
        B = len(sl)
        pm, base, W, d_max, len1, len2 = _stage(
            off, seqs, [rows1[i] for i in sl], [rows2[i] for i in sl],
            [gap_opens[i] for i in sl], [0] * B, [0] * B, band, dev)
        best, ops, _ = moves_plain(buf, pm, base, W, d_max, band, match,
                                   mismatch, gap_ext)
        res = _reconstruct(best.cpu().numpy(), ops.cpu().numpy(), len1, len2)
        for i, r in zip(sl, res):
            out[i] = r
    return out


def stats_calls(calls, device="cpu", max_pairs=4096) -> List[list]:
    """``stats_call`` of many calls, their chunks run together in
    ``stats_rows_each`` batches of up to ``max_pairs`` pairs that share
    scoring and band.  ``calls``: (seqs, rows1, rows2, gap_opens, ks,
    match_ids, (match, mismatch, gap_ext), band) each; returns each call's
    list of ``(aligned_ratio_s1, aligned_ratio_s2, identity)``."""
    dev = torch.device(device)
    out = [[None] * len(c[1]) for c in calls]
    groups = {}
    for ci, (seqs, rows1, rows2, gap_opens, ks, match_ids, scoring,
             band) in enumerate(calls):
        if not len(rows1):
            continue
        for sl in _plan_chunks(seqs, rows1, rows2):
            r1 = [rows1[i] for i in sl]
            r2 = [rows2[i] for i in sl]
            len1 = np.fromiter((seqs[r].size for r in r1), np.int64)
            len2 = np.fromiter((seqs[r].size for r in r2), np.int64)
            n = _bucket_width(int(len1.max()))
            m = _bucket_width(int(len2.max()))
            key = (int(len1.min()), int(len1.max()), int(len2.min()),
                   int(len2.max()), n, m, band)
            base, W = _window_schedule_raw(len1, len2, n, m, band, key)
            groups.setdefault((tuple(scoring), band), []).append(
                (ci, sl, seqs, r1, r2, base[0], W,
                 int((len1 + len2).max()),
                 [gap_opens[i] for i in sl], [ks[i] for i in sl],
                 [match_ids[i] for i in sl]))
    for (scoring, band), chunks in groups.items():
        batch, size = [], 0
        for ch in chunks:
            if batch and size + len(ch[1]) > max_pairs:
                _run_each(batch, scoring, band, dev, out)
                batch, size = [], 0
            batch.append(ch)
            size += len(ch[1])
        if batch:
            _run_each(batch, scoring, band, dev, out)
    return out


def _run_each(batch, scoring, band, dev, out) -> None:
    """One ``stats_rows_each`` launch over a list of staged chunks."""
    seq_list, index = [], {}
    rows_a, rows_b = [], []
    for ch in batch:
        seqs = ch[2]
        for r1, r2 in zip(ch[3], ch[4]):
            for r in (r1, r2):
                if (id(seqs), r) not in index:
                    index[(id(seqs), r)] = len(seq_list)
                    seq_list.append(seqs[r])
            rows_a.append(index[(id(seqs), r1)])
            rows_b.append(index[(id(seqs), r2)])
    buf, off = _pool(seq_list, list(range(len(seq_list))), dev)
    B = len(rows_a)
    d_max = max(ch[7] for ch in batch)
    pm = np.zeros((B, 8), np.int64)
    bases = np.zeros((d_max + 1, B), np.int64)
    widths = np.zeros(B, np.int64)
    d_maxes = np.zeros(B, np.int64)
    at = 0
    for ch in batch:
        k = len(ch[1])
        pm[at: at + k, 2] = ch[8]
        pm[at: at + k, 3] = ch[9]
        pm[at: at + k, 4] = ch[10]
        sched = ch[5][: ch[7] + 1].astype(np.int64)
        bases[: sched.size, at: at + k] = sched[:, None]
        bases[sched.size:, at: at + k] = sched[-1]
        widths[at: at + k] = ch[6]
        d_maxes[at: at + k] = ch[7]
        at += k
    pm[:, 0] = [seq_list[r].size for r in rows_a]
    pm[:, 1] = [seq_list[r].size for r in rows_b]
    pm[:, 5] = [off[r] for r in rows_a]
    pm[:, 6] = [off[r] for r in rows_b]
    t = lambda a: torch.from_numpy(a).to(dev)
    match, mismatch, gap_ext = scoring
    best = stats_rows_each(buf, t(pm), t(bases), t(widths), t(d_maxes), band,
                           match, mismatch, gap_ext).cpu().numpy()
    res = _gather_chunk(best, pm[:, 0], pm[:, 1], pm[:, 3], pm[:, 4], band)
    at = 0
    for ch in batch:
        for i, r in zip(ch[1], res[at: at + len(ch[1])]):
            out[ch[0]][i] = r
        at += len(ch[1])
