"""ctypes loader for the native DP engine (lazy-built with g++).

The shared object is built once per machine into the package's ``_build/``
directory (ignored by git);
when no compiler is available the caller falls back to the numpy mirror
(ops/align.py decides).  Semantics are cell-exact vs the other backends for
gap_open > gap_ext (always true in this pipeline: tiers 2-5 vs ext 1);
tests/test_native.py verifies move-level parity.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "sgdp.cpp")
_SO = os.path.join(os.path.dirname(_DIR), "_build", "_sgdp.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # -ffp-contract=off: no FMA contraction, so double accumulations round
    # exactly like the numpy mirrors they must be bit-identical to.
    # built under a per-process name and renamed into place, so that
    # processes building at once never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
           "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        logger.debug("native DP build failed: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.isfile(_SO) or (
            os.path.isfile(_SRC) and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            logger.debug("native DP load failed: %s", e)
            return None
        lib.sg_align_batch_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sg_align_batch_native.restype = None
        lib.sg_block_stats_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.sg_block_stats_native.restype = None
        lib.sg_block_stats_ptr_native.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.sg_block_stats_ptr_native.restype = None
        lib.sg_identity_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.sg_identity_native.restype = None
        lib.sg_pileup_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sg_pileup_native.restype = None
        lib.read_error_stats_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.read_error_stats_native.restype = None
        lib.stage1_stats_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.stage1_stats_native.restype = None
        lib.decide_wave_native.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.decide_wave_native.restype = ctypes.c_int64
        lib.minimizers_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.minimizers_native.restype = None
        lib.minimizers_flat_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.minimizers_flat_native.restype = None
        lib.find_newlines_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        lib.find_newlines_native.restype = ctypes.c_int64
        lib.hpol_compress_native.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.hpol_compress_native.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


# Reusable staging/output buffers.  On hosts with slow memory, per-call
# np.zeros/np.empty of the padded (B, stride) matrices costs more in page
# faults than the kernels themselves; these grow monotonically and are
# reused.  The kernels never read padding bytes (every row is consumed up to
# its own length), so no zero-fill is needed.  Thread-local: the production
# pipeline calls from one control thread per process, but the ThreadWorld
# distributed transport (and any threaded embedder) runs several ranks as
# threads of one process — a shared buffer would race.
_scratch = threading.local()


def _scratch_buf(name: str, shape: Tuple[int, ...], dtype) -> np.ndarray:
    need = 1
    for d in shape:
        need *= int(d)
    store = _scratch.__dict__
    buf = store.get(name)
    if buf is None or buf.size < need or buf.dtype != np.dtype(dtype):
        buf = np.empty(max(need, 1), dtype=dtype)
        store[name] = buf
    return buf[:need].reshape(shape)


def _stage_rows(name: str, rows: List[np.ndarray], stride: int) -> np.ndarray:
    """Pad a ragged list of byte rows into a reused (B, stride) matrix."""
    mat = _scratch_buf(name, (len(rows), stride), np.uint8)
    for i, r in enumerate(rows):
        mat[i, : r.size] = r
    return mat


def find_newlines(data: np.ndarray) -> Optional[np.ndarray]:
    """Positions of b'\\n' in a uint8 array via the SIMD scanner; None when
    the native engine is unavailable (caller uses the numpy path)."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(data.size)
    cap = n // 256 + 1024           # typical fastq line >= ~300 bytes
    while True:
        out = np.empty(cap, dtype=np.int64)
        got = lib.find_newlines_native(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
        if got <= cap:
            return out[:got]
        cap = int(got)


def hpol_compress(flat: np.ndarray,
                  bounds: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Homopolymer-compress a concatenated read buffer (reference
    cluster.py:265 groupby-first semantics).

    Returns (comp, cb): the compacted run-first bytes and n+1 per-read
    offsets into them; None when the native engine is unavailable.  The
    values are identical to the boolean-mask numpy path in
    cluster/store.build_store — this exists because the mask + reduceat +
    gather triple costs seconds at 100k-1M read scale while the two-pass
    OpenMP scan is memory-speed."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(bounds.size) - 1
    total = int(bounds[-1])
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    comp = np.empty(max(total, 1), dtype=np.uint8)
    cb = np.empty(n + 1, dtype=np.int64)
    lib.hpol_compress_native(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        comp.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cb.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return comp[: int(cb[-1])], cb


def align_batch_native(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    band: int = 0,
) -> List[np.ndarray]:
    lib = get_lib()
    assert lib is not None, "native DP engine unavailable"
    B = len(pairs)
    s1b, s2b, len1, len2, n_stride, m_stride = _pack_pairs(pairs)
    opens = np.asarray(gap_opens, dtype=np.int32)
    moves_out = _scratch_buf("aln.moves", (B, n_stride + m_stride), np.uint8)
    moves_len = np.empty(B, dtype=np.int32)
    scores = np.empty(B, dtype=np.int32)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.sg_align_batch_native(
        p(s1b, ctypes.c_uint8), p(s2b, ctypes.c_uint8),
        p(len1, ctypes.c_int32), p(len2, ctypes.c_int32),
        p(opens, ctypes.c_int32),
        B, n_stride, m_stride, match, mismatch, gap_ext, band,
        p(moves_out, ctypes.c_uint8), p(moves_len, ctypes.c_int32),
        p(scores, ctypes.c_int32),
    )
    return [moves_out[i, : moves_len[i]].copy() for i in range(B)]


def _pack_pairs(pairs):
    n_stride = max(a.size for a, _ in pairs)
    m_stride = max(b.size for _, b in pairs)
    s1b = _stage_rows("pp.s1", [a for a, _ in pairs], n_stride)
    s2b = _stage_rows("pp.s2", [b for _, b in pairs], m_stride)
    len1 = np.array([a.size for a, _ in pairs], dtype=np.int32)
    len2 = np.array([b.size for _, b in pairs], dtype=np.int32)
    return s1b, s2b, len1, len2, n_stride, m_stride


def block_stats_native(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    ks: List[int], match_ids: List[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1, band: int = 0,
):
    """(aligned_ratio, target_ratio) per pair, computed entirely in C."""
    lib = get_lib()
    assert lib is not None
    s1b, s2b, len1, len2, n_stride, m_stride = _pack_pairs(pairs)
    B = len(pairs)
    ratios = np.empty(2 * B, dtype=np.float64)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.sg_block_stats_native(
        p(s1b, ctypes.c_uint8), p(s2b, ctypes.c_uint8),
        p(len1, ctypes.c_int32), p(len2, ctypes.c_int32),
        p(np.asarray(gap_opens, dtype=np.int32), ctypes.c_int32),
        p(np.asarray(ks, dtype=np.int32), ctypes.c_int32),
        p(np.asarray(match_ids, dtype=np.int32), ctypes.c_int32),
        B, n_stride, m_stride, match, mismatch, gap_ext, band,
        p(ratios, ctypes.c_double),
    )
    return [(ratios[2 * i], ratios[2 * i + 1]) for i in range(B)]


def block_stats_ptr_native(
    s1_addr: np.ndarray, len1: np.ndarray,
    s2_addr: np.ndarray, len2: np.ndarray,
    gap_opens: np.ndarray, ks: np.ndarray, match_ids: np.ndarray,
    match: int = 2, mismatch: int = -2, gap_ext: int = 1, band: int = 0,
):
    """block_stats over rows addressed by pointer arrays (int64 addresses of
    contiguous uint8 rows) — no staging copies.  The caller must keep the
    owning buffers alive for the duration of the call."""
    lib = get_lib()
    assert lib is not None
    B = int(len1.size)
    ratios = np.empty(2 * B, dtype=np.float64)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.sg_block_stats_ptr_native(
        p(np.ascontiguousarray(s1_addr, np.int64), ctypes.c_int64),
        p(np.ascontiguousarray(s2_addr, np.int64), ctypes.c_int64),
        p(np.ascontiguousarray(len1, np.int32), ctypes.c_int32),
        p(np.ascontiguousarray(len2, np.int32), ctypes.c_int32),
        p(np.ascontiguousarray(gap_opens, np.int32), ctypes.c_int32),
        p(np.ascontiguousarray(ks, np.int32), ctypes.c_int32),
        p(np.ascontiguousarray(match_ids, np.int32), ctypes.c_int32),
        B, match, mismatch, gap_ext, band,
        p(ratios, ctypes.c_double),
    )
    return [(ratios[2 * i], ratios[2 * i + 1]) for i in range(B)]


def read_error_stats_native(
    seqs: List[np.ndarray], quals: List[np.ndarray], p_table: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-read (hpol_error_rate, full_error_rate) — bit-identical to
    cluster/store.py's numpy accumulation, one linear pass per read in C."""
    lib = get_lib()
    assert lib is not None
    B = len(seqs)
    if B > 16384:  # bound the padded staging buffers (B x stride x 2 bytes)
        he = np.empty(B, dtype=np.float64)
        fe = np.empty(B, dtype=np.float64)
        for s in range(0, B, 16384):
            he[s : s + 16384], fe[s : s + 16384] = read_error_stats_native(
                seqs[s : s + 16384], quals[s : s + 16384], p_table)
        return he, fe
    stride = max((s.size for s in seqs), default=1)
    sb = _stage_rows("es.seq", seqs, stride)
    qb = _stage_rows("es.qual", quals, stride)
    lens = np.array([s.size for s in seqs], dtype=np.int32)
    hpol_err = np.empty(B, dtype=np.float64)
    full_err = np.empty(B, dtype=np.float64)
    p_table = np.ascontiguousarray(p_table, dtype=np.float64)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.read_error_stats_native(
        p(sb, ctypes.c_uint8), p(qb, ctypes.c_uint8),
        p(lens, ctypes.c_int32), B, stride,
        p(p_table, ctypes.c_double),
        p(hpol_err, ctypes.c_double), p(full_err, ctypes.c_double),
    )
    return hpol_err, full_err


def stage1_stats_native(
    seqs: List[np.ndarray], quals: List[np.ndarray], k: int,
    p_capped: np.ndarray, p_uncapped: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fused stage-1 per-read stats: (scores, error_rates, hpol_lens).

    Bit-identical to ops/score.py::batch_scores / batch_error_rates and the
    hpol-length filter, one streaming pass per read (see sgdp.cpp)."""
    lib = get_lib()
    assert lib is not None
    B = len(seqs)
    if B > 16384:  # bound the padded staging buffers
        sc = np.empty(B, dtype=np.float64)
        er = np.empty(B, dtype=np.float64)
        hl = np.empty(B, dtype=np.int32)
        for s in range(0, B, 16384):
            sc[s:s + 16384], er[s:s + 16384], hl[s:s + 16384] = (
                stage1_stats_native(seqs[s:s + 16384], quals[s:s + 16384],
                                    k, p_capped, p_uncapped))
        return sc, er, hl
    stride = max((s.size for s in seqs), default=1)
    sb = _stage_rows("s1.seq", seqs, stride)
    qb = _stage_rows("s1.qual", quals, stride)
    lens = np.array([s.size for s in seqs], dtype=np.int32)
    scores = np.empty(B, dtype=np.float64)
    errs = np.empty(B, dtype=np.float64)
    hpol_lens = np.empty(B, dtype=np.int32)
    p_capped = np.ascontiguousarray(p_capped, dtype=np.float64)
    p_uncapped = np.ascontiguousarray(p_uncapped, dtype=np.float64)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.stage1_stats_native(
        p(sb, ctypes.c_uint8), p(qb, ctypes.c_uint8),
        p(lens, ctypes.c_int32), B, stride, k,
        p(p_capped, ctypes.c_double), p(p_uncapped, ctypes.c_double),
        p(scores, ctypes.c_double), p(errs, ctypes.c_double),
        p(hpol_lens, ctypes.c_int32),
    )
    return scores, errs, hpol_lens


def minimizers_native(
    seqs: List[np.ndarray], k: int, w: int,
    rank_of: np.ndarray, rank_bits: int,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Minimizer (codes, positions) per sequence — exact emission semantics
    of ops/minimizers.py, deque-free sequential scan in C.  Caller must
    ensure k * rank_bits <= 62."""
    lib = get_lib()
    assert lib is not None
    B = len(seqs)
    if B > 4096:  # bound the (B, stride) int64 output buffers
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        for s in range(0, B, 4096):
            out.extend(minimizers_native(seqs[s:s + 4096], k, w,
                                         rank_of, rank_bits))
        return out
    stride = max((s.size for s in seqs), default=1)
    sb = _stage_rows("min.seq", seqs, stride)
    lens = np.array([s.size for s in seqs], dtype=np.int32)
    out_codes = _scratch_buf("min.codes", (B, stride), np.int64)
    out_pos = _scratch_buf("min.pos", (B, stride), np.int64)
    out_counts = _scratch_buf("min.counts", (B,), np.int32)
    rank_of = np.ascontiguousarray(rank_of, dtype=np.int64)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.minimizers_native(
        p(sb, ctypes.c_uint8), p(lens, ctypes.c_int32), B, stride, k, w,
        p(rank_of, ctypes.c_int64), rank_bits,
        p(out_codes, ctypes.c_int64), p(out_pos, ctypes.c_int64),
        p(out_counts, ctypes.c_int32),
    )
    # compact the padded scratch rows with one vectorized gather; the
    # per-read results are views into the two fresh flat arrays (B per-row
    # .copy() calls cost more than the whole C scan at 100k+ reads)
    counts = out_counts.astype(np.int64)
    bounds = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    total = int(bounds[-1])
    within = np.arange(total, dtype=np.int64) - np.repeat(bounds[:-1], counts)
    src = np.repeat(np.arange(B, dtype=np.int64) * stride, counts) + within
    flat_codes = out_codes.reshape(-1)[src]
    flat_pos = out_pos.reshape(-1)[src]
    return [(flat_codes[bounds[b]:bounds[b + 1]], flat_pos[bounds[b]:bounds[b + 1]])
            for b in range(B)]


def minimizers_flat_native(
    flat: np.ndarray, offsets: np.ndarray, k: int, w: int,
    rank_of: np.ndarray, rank_bits: int,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Minimizers over rows of one contiguous buffer (row b spans
    flat[offsets[b], offsets[b+1])) — no staging copies.  Same emission
    semantics as minimizers_native; per-row results are views into two
    fresh compacted flat arrays."""
    lib = get_lib()
    assert lib is not None
    B = int(offsets.size) - 1
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if B > 8192:  # bound the int64 output scratch (2 entries per input byte)
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        for s in range(0, B, 8192):
            sub = offsets[s : s + 8193]
            out.extend(minimizers_flat_native(
                flat[sub[0]:sub[-1]], sub - sub[0], k, w, rank_of, rank_bits))
        return out
    total = int(offsets[-1])
    out_codes = _scratch_buf("minf.codes", (max(total, 1),), np.int64)
    out_pos = _scratch_buf("minf.pos", (max(total, 1),), np.int64)
    out_counts = _scratch_buf("minf.counts", (max(B, 1),), np.int32)
    rank_of = np.ascontiguousarray(rank_of, dtype=np.int64)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.minimizers_flat_native(
        p(flat, ctypes.c_uint8), p(offsets, ctypes.c_int64), B, k, w,
        p(rank_of, ctypes.c_int64), rank_bits,
        p(out_codes, ctypes.c_int64), p(out_pos, ctypes.c_int64),
        p(out_counts, ctypes.c_int32),
    )
    counts = out_counts[:B].astype(np.int64)
    bounds = np.zeros(B + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    n_out = int(bounds[-1])
    within = np.arange(n_out, dtype=np.int64) - np.repeat(bounds[:-1], counts)
    src = np.repeat(offsets[:-1], counts) + within
    flat_codes = out_codes[src]
    flat_pos = out_pos[src]
    return [(flat_codes[bounds[b]:bounds[b + 1]], flat_pos[bounds[b]:bounds[b + 1]])
            for b in range(B)]


def decide_wave_native(
    codes: np.ndarray, pos: np.ndarray, roff: np.ndarray,
    wave_rows: np.ndarray, wave_ids: np.ndarray,
    snap,  # (base_codes, base_off, base_posts, d_codes, d_off, d_posts)
    row_of_id: np.ndarray, eidx: np.ndarray, hpol_len: np.ndarray,
    acc_rank: np.ndarray, gmax: np.ndarray,
    min_shared: int, min_fraction: float, mapped_threshold: float,
    symmetric: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Batched wave decision (engine._decide_waves) in C.  Returns
    (decisions, nr_shared, cand_off, cand_flat)."""
    lib = get_lib()
    assert lib is not None
    base_codes, base_off, base_posts, d_codes, d_off, d_posts = snap
    n_wave = int(wave_rows.size)
    decisions = np.empty(n_wave, dtype=np.int64)
    nr_shared = np.empty(n_wave, dtype=np.int64)
    cand_off = np.empty(n_wave + 1, dtype=np.int64)
    cand_cap = max(8 * n_wave + 64, 1)
    bidx, bshift = _base_bucket_index(base_codes)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    I = ctypes.c_int64
    while True:
        cand_flat = np.empty(cand_cap, dtype=np.int64)
        need = lib.decide_wave_native(
            p(codes, I), p(pos, I), p(roff, I),
            p(wave_rows, I), p(wave_ids, I), n_wave,
            p(base_codes, I), p(base_off, I), p(base_posts, I),
            int(base_codes.size),
            p(d_codes, I), p(d_off, I), p(d_posts, I), int(d_codes.size),
            p(row_of_id, I),
            p(eidx, ctypes.c_int8), p(hpol_len, I), p(acc_rank, I),
            p(gmax, I),
            int(min_shared), float(min_fraction), float(mapped_threshold),
            int(symmetric),
            (p(bidx, I) if bidx is not None
             else ctypes.cast(None, ctypes.POINTER(I))), int(bshift),
            p(decisions, I), p(nr_shared, I),
            p(cand_flat, I), cand_cap, p(cand_off, I),
        )
        if need == 0:
            return decisions, nr_shared, cand_off, cand_flat
        cand_cap = int(need)


#: top-16-bit radix bucket starts over a (compacted, immutable) base-codes
#: array, cached per array object: the base only changes on MinimizerDB
#: compaction, so the 65537-entry searchsorted runs a few dozen times per
#: clustering pass.  Holding the codes array in the cache value pins its
#: id() (entries die with the cache, bounded below).
_BIDX_CACHE: dict = {}


def _base_bucket_index(base_codes: np.ndarray):
    n = int(base_codes.size)
    if n < 4096:
        return None, 0
    key = id(base_codes)
    hit = _BIDX_CACHE.get(key)
    if hit is not None and hit[0] is base_codes:
        return hit[1], hit[2]
    shift = 0
    mx = int(base_codes[-1])
    while (mx >> shift) >= 65536:
        shift += 1
    bounds = np.arange(65537, dtype=np.int64) << shift
    bidx = np.ascontiguousarray(
        np.searchsorted(base_codes, bounds, side="left"), dtype=np.int64)
    if len(_BIDX_CACHE) > 64:
        _BIDX_CACHE.clear()
    _BIDX_CACHE[key] = (base_codes, bidx, shift)
    return bidx, shift


def pileup_native(
    center: np.ndarray,
    reads: List[np.ndarray],
    weights: Optional[List[np.ndarray]],
    match: int, mismatch: int, gap_open: int, gap_ext: int, band: int,
    windows: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fused DP + pileup accumulation for one center (the polish hot loop).

    Returns (votes (L,5), qvotes (L,5), coverage (L+1), ev_pos, ev_w,
    ev_len, ev_bytes) where the ev_* arrays are insertion events in read
    order: ev_bytes holds the inserted base runs back-to-back (offsets =
    cumulative ev_len).  Accumulation is sequential in read order inside
    the engine, so floats are bit-identical to the Python walk.

    windows: optional (B, 2) int32 of per-read center spans [lo, hi) — the
    DP runs only against that center slice (anchor-bounded polish for long
    centers); positions are reported in center coordinates."""
    lib = get_lib()
    assert lib is not None
    L = center.size
    B = len(reads)
    rstride = max((r.size for r in reads), default=1)
    rb = _stage_rows("pu.reads", reads, rstride)
    rlen = np.array([r.size for r in reads], dtype=np.int32)
    if windows is None:
        win_lo = np.zeros(B, dtype=np.int32)
        win_hi = np.full(B, L, dtype=np.int32)
    else:
        win_lo = np.ascontiguousarray(windows[:, 0], dtype=np.int32)
        win_hi = np.ascontiguousarray(windows[:, 1], dtype=np.int32)
    has_w = weights is not None
    wb = _scratch_buf("pu.w", (B, rstride), np.float64)
    if has_w:
        for i, w in enumerate(weights):
            wb[i, : w.size] = w
    votes = np.zeros((L, 5), dtype=np.float64)
    qvotes = np.zeros((L, 5), dtype=np.float64)
    coverage = np.zeros(L + 1, dtype=np.float64)
    ev_cap = max(1, int(rlen.sum()))
    ev_pos = _scratch_buf("pu.evpos", (ev_cap,), np.int32)
    ev_w = _scratch_buf("pu.evw", (ev_cap,), np.float64)
    ev_len = _scratch_buf("pu.evlen", (ev_cap,), np.int32)
    ev_bytes = _scratch_buf("pu.evbytes", (ev_cap,), np.uint8)
    n_ev = np.zeros(1, dtype=np.int64)
    n_ev_bytes = np.zeros(1, dtype=np.int64)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    center = np.ascontiguousarray(center, dtype=np.uint8)
    lib.sg_pileup_native(
        p(center, ctypes.c_uint8), L,
        p(rb, ctypes.c_uint8), p(rlen, ctypes.c_int32), B, rstride,
        p(win_lo, ctypes.c_int32), p(win_hi, ctypes.c_int32),
        p(wb, ctypes.c_double), int(has_w),
        match, mismatch, gap_open, gap_ext, band,
        p(votes, ctypes.c_double), p(qvotes, ctypes.c_double),
        p(coverage, ctypes.c_double),
        p(ev_pos, ctypes.c_int32), p(ev_w, ctypes.c_double),
        p(ev_len, ctypes.c_int32), p(ev_bytes, ctypes.c_uint8),
        p(n_ev, ctypes.c_int64), p(n_ev_bytes, ctypes.c_int64),
    )
    ne = int(n_ev[0])
    nb = int(n_ev_bytes[0])
    # copies: the ev_* buffers are reused scratch
    return (votes, qvotes, coverage,
            ev_pos[:ne].copy(), ev_w[:ne].copy(),
            ev_len[:ne].copy(), ev_bytes[:nb].copy())


def identity_native(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1, band: int = 0,
):
    """Column identity per pair (matches / alignment columns), in C."""
    lib = get_lib()
    assert lib is not None
    s1b, s2b, len1, len2, n_stride, m_stride = _pack_pairs(pairs)
    B = len(pairs)
    out = np.empty(B, dtype=np.float64)

    def p(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    lib.sg_identity_native(
        p(s1b, ctypes.c_uint8), p(s2b, ctypes.c_uint8),
        p(len1, ctypes.c_int32), p(len2, ctypes.c_int32),
        p(np.asarray(gap_opens, dtype=np.int32), ctypes.c_int32),
        B, n_stride, m_stride, match, mismatch, gap_ext, band,
        p(out, ctypes.c_double),
    )
    return out.tolist()
