// Native batched semi-global Gotoh DP + traceback.
//
// Cell-exact mirror of ops/align.py::_sg_dp_np_batch (same recurrences, same
// tie-breaking, same packed bit layout) for the host execution path: the
// runtime-side counterpart of the Pallas kernel, used where the reference
// links parasail's C engine (SURVEY.md N1).  Integer-only arithmetic, so
// bit-parity with the numpy/XLA/Pallas backends is structural, and verified
// by tests/test_native.py.
//
// Built with scripts/build_native.sh (or lazily by ngspeciesid_tpu/native.py)
// into _sgdp.so; loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

#if defined(__AVX512F__) && defined(__AVX512BW__) && defined(__AVX512VL__)
#include <immintrin.h>
#define NGSID_AVX512 1
#endif

namespace {

constexpr int32_t NEG_INF = -(1 << 30);
constexpr uint8_t MV_DIAG = 1, MV_UP = 2, MV_LEFT = 3;

struct PairResult {
    int32_t score;
    int32_t end_i;
    int32_t end_j;
};

// Per-thread reusable workspace: no per-pair allocation, and — critically —
// no per-pair O(n*m) zero-fill of the move matrix.  The packed matrix is
// stored band-compressed ((n+1) x band_stride with a per-row column base
// jlo[i]); every cell inside a row's window is written by the DP before the
// traceback can read it, and reads outside the window are clamped to 0 by
// cell_at(), so reusing the buffers across pairs is deterministic.
struct DpScratch {
    std::vector<uint8_t> packed;
    std::vector<int32_t> jlo, jhi;
    std::vector<int32_t> H, Hn, F, hne, diag_row, E_row;
    std::vector<int16_t> H16, Hn16, F16, hne16, diag16, E16;
    std::vector<int16_t> g16, p16, cbuf16;   // fused-row pipeline scratch
    std::vector<uint32_t> fmask32;
    std::vector<uint8_t> fopen_row, eopen_row;
    std::vector<uint8_t> moves;
    int band_stride = 0;

    // Widest row window of the banded schedule for an (n, m) problem.
    static int max_band_width(int n, int m, int band_hw) {
        if (band_hw <= 0 || n <= 0) return m;
        int widest = 1, prev_hi = m;
        for (int i = 1; i <= n; ++i) {
            long ci = (long)i * m / n;
            int j_lo = (int)std::max(1L, ci - band_hw);
            int j_hi = (int)std::min((long)m, ci + band_hw);
            j_lo = std::min(j_lo, prev_hi + 1);
            prev_hi = j_hi;
            widest = std::max(widest, j_hi - j_lo + 1);
        }
        return widest;
    }

    void prepare(int n, int m, int band_hw) {
        band_stride = max_band_width(n, m, band_hw);
        // +64: the fused row pipeline writes full 32-byte move vectors that
        // may overrun a row's end into the next row (rewritten before any
        // read) and past the final row's end.
        size_t need = (size_t)(n + 1) * band_stride + 64;
        if (packed.size() < need) packed.resize(need);
        if ((int)jlo.size() < n + 1) { jlo.resize(n + 1); jhi.resize(n + 1); }
        if ((int)H.size() < m + 1) {
            H.resize(m + 1); Hn.resize(m + 1); F.resize(m + 1);
            hne.resize(m + 1); diag_row.resize(m + 1); E_row.resize(m + 1);
            // +33: SIMD loads/stores run up to a full vector past j_hi
            H16.resize(m + 33); Hn16.resize(m + 33); F16.resize(m + 33);
            hne16.resize(m + 33); diag16.resize(m + 33); E16.resize(m + 33);
            g16.resize(m + 33); p16.resize(m + 33);
            fopen_row.resize(m + 33); eopen_row.resize(m + 33);
        }
        int nvec = m / 32 + 2;
        if ((int)fmask32.size() < nvec) { fmask32.resize(nvec); cbuf16.resize(nvec); }
        if ((int)moves.size() < n + m) moves.resize(n + m);
    }

    inline uint8_t cell_at(int i, int j) const {
        if (j < jlo[i] || j > jhi[i]) return 0;
        return packed[(size_t)i * band_stride + (j - jlo[i])];
    }
};

// Narrow-lane support: for pairs whose every DP quantity provably fits in
// int16 (see fits_int16 below) the whole row pipeline runs at twice the
// SIMD width.  The arithmetic is identical integer arithmetic — no
// saturation can occur under the gate — so moves/scores are bit-identical
// to the int32 path (differential-tested in tests/test_native.py).
constexpr int16_t NEG_INF16 = -16384;

template <typename T> struct CellTraits;
template <> struct CellTraits<int32_t> {
    static constexpr int32_t NEG = NEG_INF;
};
template <> struct CellTraits<int16_t> {
    static constexpr int16_t NEG = NEG_INF16;
};

// Every sentinel-derived value stays above NEG - (n+m)*unit - open and every
// real value below unit*min(n,m) + m*ext; with NEG16 = -16384 both fit int16
// when this bound holds.
inline bool fits_int16(int n, int m, int match, int mismatch,
                       int gap_open, int gap_ext) {
    long unit = std::max({(long)gap_ext, (long)match, (long)-mismatch,
                          (long)gap_open});
    return (long)(n + m + 2) * unit + gap_open + 64 <= 16000;
}

// Row passes extracted into functions so the no-alias contract is carried
// by PARAMETER __restrict__ — robust against the H/Hn pointer swap in the
// caller, which otherwise defeats block-scope restrict and costs the
// vectorization of these loops (measured 2.6x).
template <typename T>
static void row_pass1(int j_lo, int j_hi, uint8_t c1, int gap_open,
                      int gap_ext, int match, int mismatch,
                      const uint8_t* __restrict__ s2,
                      const T* __restrict__ H,
                      T* __restrict__ F,
                      T* __restrict__ hne,
                      T* __restrict__ diag_row,
                      uint8_t* __restrict__ fopen_row) {
    for (int j = j_lo; j <= j_hi; ++j) {
        T f_open = (T)(H[j] - gap_open);
        T f_ext = (T)(F[j] - gap_ext);
        T f = f_open >= f_ext ? f_open : f_ext;
        fopen_row[j] = f_open >= f_ext;
        F[j] = f;
        T sub = (s2[j - 1] == c1) ? (T)match : (T)mismatch;
        T diag = (T)(H[j - 1] + sub);
        diag_row[j] = diag;
        hne[j] = diag > f ? diag : f;
    }
}

// Pass 2: the E-chain running max.  T_j = max(T_{j-1}, g_j) with
// g_j = hne[j-1] - open + j*ext is an inclusive prefix-max over a drift-
// corrected sequence; eopen marks chain openings (g_j >= T_{j-1}).  All
// terms are bounded by |NEG| + m*gap_ext + gap_open, which the lane-width
// gate keeps exact.  The caller primes hne[j_lo - 1] with H[i][j_lo-1].
static void row_pass2(int j_lo, int j_hi, int gap_open, int gap_ext,
                      const int32_t* __restrict__ hne,
                      int32_t* __restrict__ E_row,
                      uint8_t* __restrict__ eopen_row) {
    int32_t T = NEG_INF;
    int j = j_lo;
#ifdef NGSID_AVX512
    const __m512i vneg = _mm512_set1_epi32(NEG_INF);
    const __m512i vopen = _mm512_set1_epi32(gap_open);
    const __m512i vext16 = _mm512_set1_epi32(16 * gap_ext);
    __m512i jext = _mm512_mullo_epi32(
        _mm512_add_epi32(_mm512_set1_epi32(j_lo),
                         _mm512_setr_epi32(0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15)),
        _mm512_set1_epi32(gap_ext));
    for (; j + 15 <= j_hi; j += 16) {
        __m512i prev = _mm512_loadu_si512(hne + j - 1);
        __m512i g = _mm512_add_epi32(_mm512_sub_epi32(prev, vopen), jext);
        // inclusive prefix max over the 16 lanes
        __m512i p = g;
        p = _mm512_max_epi32(p, _mm512_alignr_epi32(p, vneg, 15));
        p = _mm512_max_epi32(p, _mm512_alignr_epi32(p, vneg, 14));
        p = _mm512_max_epi32(p, _mm512_alignr_epi32(p, vneg, 12));
        p = _mm512_max_epi32(p, _mm512_alignr_epi32(p, vneg, 8));
        __m512i carry = _mm512_set1_epi32(T);
        // exclusive prefix (previous T per lane) for the eopen test
        __m512i tex = _mm512_max_epi32(carry,
                          _mm512_alignr_epi32(p, vneg, 15));
        __mmask16 ge = _mm512_cmp_epi32_mask(g, tex, _MM_CMPINT_NLT);
        _mm_storeu_si128((__m128i*)(eopen_row + j),
                         _mm_maskz_set1_epi8(ge, 1));
        __m512i tinc = _mm512_max_epi32(carry, p);
        _mm512_storeu_si512(E_row + j, _mm512_sub_epi32(tinc, jext));
        T = _mm512_reduce_max_epi32(tinc);
        jext = _mm512_add_epi32(jext, vext16);
    }
#endif
    for (; j <= j_hi; ++j) {
        int32_t g = hne[j - 1] - gap_open + j * gap_ext;
        eopen_row[j] = g >= T;
        T = g >= T ? g : T;
        E_row[j] = T - j * gap_ext;
    }
}

// int16 variant: 32 lanes per vector.  Full-vector 16-bit lane shifts use
// permutexvar_epi16 with merge-masking from the NEG vector (alignr_epi8
// only shifts within 128-bit lanes).
static void row_pass2(int j_lo, int j_hi, int gap_open, int gap_ext,
                      const int16_t* __restrict__ hne,
                      int16_t* __restrict__ E_row,
                      uint8_t* __restrict__ eopen_row) {
    int16_t T = NEG_INF16;
    int j = j_lo;
#if defined(NGSID_AVX512)
    const __m512i vneg = _mm512_set1_epi16(NEG_INF16);
    const __m512i vopen = _mm512_set1_epi16((int16_t)gap_open);
    const __m512i vext32 = _mm512_set1_epi16((int16_t)(32 * gap_ext));
    __m512i lane = _mm512_setr_epi32(0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15);
    // per-lane indices 0..31 as epi16
    alignas(64) int16_t idx_buf[32];
    for (int t = 0; t < 32; ++t) idx_buf[t] = (int16_t)t;
    const __m512i lanes16 = _mm512_load_si512(idx_buf);
    (void)lane;
    __m512i jext = _mm512_mullo_epi16(
        _mm512_add_epi16(_mm512_set1_epi16((int16_t)j_lo), lanes16),
        _mm512_set1_epi16((int16_t)gap_ext));
    // shift-by-k index vectors: dst lane i reads src lane i-k (i >= k)
    alignas(64) int16_t sbuf[32];
    __m512i shift_idx[6];
    __mmask32 shift_msk[6];
    for (int s = 0, k = 1; k <= 32; ++s, k <<= 1) {
        for (int t = 0; t < 32; ++t) sbuf[t] = (int16_t)((t - k) & 31);
        shift_idx[s] = _mm512_load_si512(sbuf);
        shift_msk[s] = (k >= 32) ? 0 : (~(__mmask32)0) << k;
    }
    for (; j + 31 <= j_hi; j += 32) {
        __m512i prev = _mm512_loadu_si512(hne + j - 1);
        __m512i g = _mm512_add_epi16(_mm512_sub_epi16(prev, vopen), jext);
        __m512i p = g;
        for (int s = 0; s < 5; ++s)
            p = _mm512_max_epi16(
                p, _mm512_mask_permutexvar_epi16(vneg, shift_msk[s],
                                                 shift_idx[s], p));
        __m512i carry = _mm512_set1_epi16(T);
        __m512i tex = _mm512_max_epi16(
            carry, _mm512_mask_permutexvar_epi16(vneg, shift_msk[0],
                                                 shift_idx[0], p));
        __mmask32 ge = _mm512_cmp_epi16_mask(g, tex, _MM_CMPINT_NLT);
        _mm256_storeu_si256((__m256i*)(eopen_row + j),
                            _mm256_maskz_set1_epi8(ge, 1));
        __m512i tinc = _mm512_max_epi16(carry, p);
        _mm512_storeu_si512(E_row + j, _mm512_sub_epi16(tinc, jext));
        // tinc is nondecreasing across lanes (prefix max + carry): lane 31
        // holds the running max
        alignas(64) int16_t tb[32];
        _mm512_store_si512(tb, tinc);
        T = tb[31];
        jext = _mm512_add_epi16(jext, vext32);
    }
#endif
    for (; j <= j_hi; ++j) {
        int16_t g = (int16_t)(hne[j - 1] - gap_open + j * gap_ext);
        eopen_row[j] = g >= T;
        T = g >= T ? g : T;
        E_row[j] = (int16_t)(T - j * gap_ext);
    }
}

template <typename T>
static void row_pass3(int j_lo, int j_hi,
                      const T* __restrict__ hne,
                      const T* __restrict__ E_row,
                      const T* __restrict__ F,
                      const T* __restrict__ diag_row,
                      const uint8_t* __restrict__ eopen_row,
                      const uint8_t* __restrict__ fopen_row,
                      T* __restrict__ Hn,
                      uint8_t* __restrict__ prow) {
    for (int j = j_lo; j <= j_hi; ++j) {
        T h = hne[j];
        T e = E_row[j];
        uint8_t mv = e > h ? MV_LEFT
                   : (F[j] > diag_row[j] ? MV_UP : MV_DIAG);
        Hn[j] = e > h ? e : h;
        prow[j] = (uint8_t)(mv | (eopen_row[j] ? 4 : 0)
                               | (fopen_row[j] ? 8 : 0));
    }
}

template <typename T>
inline void scratch_rows(DpScratch& scr, T*& H, T*& Hn, T*& F, T*& hne,
                         T*& diag_row, T*& E_row);
template <>
inline void scratch_rows<int32_t>(DpScratch& scr, int32_t*& H, int32_t*& Hn,
                                  int32_t*& F, int32_t*& hne,
                                  int32_t*& diag_row, int32_t*& E_row) {
    H = scr.H.data(); Hn = scr.Hn.data(); F = scr.F.data();
    hne = scr.hne.data(); diag_row = scr.diag_row.data();
    E_row = scr.E_row.data();
}
template <>
inline void scratch_rows<int16_t>(DpScratch& scr, int16_t*& H, int16_t*& Hn,
                                  int16_t*& F, int16_t*& hne,
                                  int16_t*& diag_row, int16_t*& E_row) {
    H = scr.H16.data(); Hn = scr.Hn16.data(); F = scr.F16.data();
    hne = scr.hne16.data(); diag_row = scr.diag16.data();
    E_row = scr.E16.data();
}

// One pair's DP; move bytes band-compressed into scratch (see DpScratch).
// band_hw > 0 computes only columns within +-band_hw of the scaled main
// diagonal c_i = i*m/n (plus the |m-n| skew) — exact whenever the optimal
// path stays inside the band, which holds for same-template amplicon pairs
// at any realistic indel rate; band_hw <= 0 is the full (reference-exact) DP.
template <typename T>
void dp_single_impl(const uint8_t* s1, const uint8_t* s2,
                    int len1, int len2, int gap_open,
                    int match, int mismatch, int gap_ext,
                    int band_hw,
                    DpScratch& scr,
                    PairResult* res) {
    const int m = len2, n = len1;
    constexpr T NEG = CellTraits<T>::NEG;
    scr.prepare(n, m, band_hw);
    // No-alias contracts live on the row-pass PARAMETERS (__restrict__
    // there); these locals are plain pointers so the H/Hn swap stays legal.
    T *H, *Hn, *F, *hne, *diag_row, *E_row;
    scratch_rows<T>(scr, H, Hn, F, hne, diag_row, E_row);
    uint8_t* __restrict__ fopen_row = scr.fopen_row.data();
    uint8_t* __restrict__ eopen_row = scr.eopen_row.data();
    for (int j = 0; j <= m; ++j) { H[j] = 0; Hn[j] = NEG; F[j] = NEG; }

    T col_best = H[m];
    int col_best_i = 0;                        // last column j == len2
    scr.jlo[0] = 1; scr.jhi[0] = 0;            // row 0 holds no move cells

    const bool banded = band_hw > 0 && n > 0;
    int prev_hi = m;
    for (int i = 1; i <= n; ++i) {
        uint8_t c1 = s1[i - 1];
        int j_lo = 1, j_hi = m;
        if (banded) {
            long ci = (long)i * m / n;
            j_lo = (int)std::max(1L, ci - band_hw);
            j_hi = (int)std::min((long)m, ci + band_hw);
            // consecutive windows must overlap (extreme length skew guard)
            j_lo = std::min(j_lo, prev_hi + 1);
            prev_hi = j_hi;
            // Stale-cell analysis: window edges are nondecreasing, so cells
            // right of every window were never written (still NEG from
            // construction) and cells left of the window are never read
            // again — EXCEPT the single left-margin cell j_lo-1, which the
            // E-chain (this row) and the diagonal (next row) read from the
            // double-buffered rows.  Clearing just that cell keeps the DP
            // O(n * band) instead of O(n * m).
            if (j_lo > 1) Hn[j_lo - 1] = NEG;
        }
        Hn[0] = 0;
        scr.jlo[i] = j_lo; scr.jhi[i] = j_hi;
        uint8_t* __restrict__ prow =
            scr.packed.data() + (size_t)i * scr.band_stride - j_lo;
        // Split the row into SIMD-friendly passes.  The left-gap state E can
        // source from h_no_e = max(diag, F) instead of the final H (classic
        // Gotoh dominance, exact for gap_open > gap_ext, which all callers
        // satisfy: open tiers 2-5 vs ext 1), which removes the only
        // loop-carried dependence except a 1-op running max.
        // pass 1 (vectorized): F update + diag + h_no_e
        row_pass1(j_lo, j_hi, c1, gap_open, gap_ext, match, mismatch,
                  s2, H, F, hne, diag_row, fopen_row);
        // pass 2 (SIMD prefix-max): running max T[j] over
        // g[j] = h_no_e[j-1] - open + j*ext; E[j] = T[j] - j*ext
        hne[j_lo - 1] = (j_lo == 1) ? (T)0 : NEG;  // H[i][j_lo-1]
        row_pass2(j_lo, j_hi, gap_open, gap_ext, hne, E_row, eopen_row);
        // pass 3 (vectorized): final H, move byte
        row_pass3(j_lo, j_hi, hne, E_row, F, diag_row, eopen_row,
                  fopen_row, Hn, prow);
        std::swap(H, Hn);
        // H[m] is only meaningful on rows whose window reached column m
        // (otherwise it is a stale value from an older row).
        if (j_hi == m && H[m] >= col_best) { col_best = H[m]; col_best_i = i; }
    }
    // last row: corner-most max (largest j wins ties), restricted to cells
    // the final row actually wrote (plus the always-valid j = 0).
    int scan_lo = (n == 0) ? 1 : scr.jlo[n];
    int scan_hi = (n == 0) ? m : scr.jhi[n];
    T row_best = H[0];
    int row_best_j = 0;
    for (int j = scan_lo; j <= scan_hi; ++j)
        if (H[j] >= row_best) { row_best = H[j]; row_best_j = j; }
    if (row_best >= col_best) {
        res->score = row_best; res->end_i = len1; res->end_j = row_best_j;
    } else {
        res->score = col_best; res->end_i = col_best_i; res->end_j = m;
    }
}

#ifdef NGSID_AVX512
// Fused int16 row pipeline (full or banded schedule) — the production
// paths.  Bit-identical to the 3-pass rows: the only change is the
// evaluation schedule of the E-chain running max, decomposed into
// independent per-32-lane-block prefix maxima plus a running carry that
// streams one block behind in vector registers (pipelined across blocks —
// the 3-pass version serializes a ~35-cycle permute chain per vector).
// Max is associative over these exact integer values, so every cell and
// move byte is unchanged (differential-tested move-level vs the numpy
// oracle in tests/test_native.py).  Single pass per row: the only
// cross-iteration dependences are three one-behind registers (prev hne /
// prev prefix / carry), so the loop is throughput-bound, not latency-bound.
// Banded rows process full 32-lane vectors with overrun past j_hi; the two
// trailing stores of NEG restore the stale-cell invariant (cells right of
// every window stay NEG) that banded window extension relies on.
void dp_single_fused_i16(const uint8_t* s1, const uint8_t* s2,
                         int len1, int len2, int gap_open,
                         int match, int mismatch, int gap_ext,
                         int band_hw,
                         DpScratch& scr, PairResult* res) {
    const int m = len2, n = len1;
    constexpr int16_t NEG = NEG_INF16;
    scr.prepare(n, m, band_hw);
    int16_t* H = scr.H16.data();
    int16_t* Hn = scr.Hn16.data();
    int16_t* Fr = scr.F16.data();
    for (int j = 0; j <= m; ++j) { H[j] = 0; Hn[j] = NEG; Fr[j] = NEG; }
    // beyond-m lanes participate in full-vector arithmetic as garbage but
    // never feed a consumed cell; zero them once so values stay bounded
    for (int j = m + 1; j < m + 33; ++j) { H[j] = 0; Hn[j] = 0; Fr[j] = 0; }

    int16_t col_best = 0;
    int col_best_i = 0;
    scr.jlo[0] = 1; scr.jhi[0] = 0;

    const __m512i vneg = _mm512_set1_epi16(NEG);
    const __m512i vopen = _mm512_set1_epi16((int16_t)gap_open);
    const __m512i vext = _mm512_set1_epi16((int16_t)gap_ext);
    const __m512i vext32 = _mm512_set1_epi16((int16_t)(32 * gap_ext));
    const __m512i vmatch = _mm512_set1_epi16((int16_t)match);
    const __m512i vmis = _mm512_set1_epi16((int16_t)mismatch);
    alignas(64) int16_t ib[32];
    // shift-by-1 across the (prev, cur) pair: lane 0 <- prev[31], lane t <- cur[t-1]
    ib[0] = 31;
    for (int t = 1; t < 32; ++t) ib[t] = (int16_t)(32 + t - 1);
    const __m512i sh1 = _mm512_load_si512(ib);
    // within-vector prefix-max shift tables (lane i <- lane i-k, NEG below)
    __m512i shift_idx[5];
    __mmask32 shift_msk[5];
    for (int s = 0, k = 1; s < 5; ++s, k <<= 1) {
        for (int t = 0; t < 32; ++t) ib[t] = (int16_t)((t - k) & 31);
        shift_idx[s] = _mm512_load_si512(ib);
        shift_msk[s] = (~(__mmask32)0) << k;
    }
    for (int t = 0; t < 32; ++t) ib[t] = (int16_t)t;
    const __m512i lanes16 = _mm512_load_si512(ib);
    const __m512i vgext = _mm512_set1_epi16((int16_t)gap_ext);
    const __m512i idx31 = _mm512_set1_epi16(31);
    const __m256i v1 = _mm256_set1_epi8(1);
    const __m256i v2 = _mm256_set1_epi8(2);
    const __m256i v3 = _mm256_set1_epi8(3);

    const bool banded = band_hw > 0 && n > 0;
    int prev_hi = m;
    for (int i = 1; i <= n; ++i) {
        const uint8_t c1 = s1[i - 1];
        int j_lo = 1, j_hi = m;
        if (banded) {
            long ci = (long)i * m / n;
            j_lo = (int)std::max(1L, ci - band_hw);
            j_hi = (int)std::min((long)m, ci + band_hw);
            j_lo = std::min(j_lo, prev_hi + 1);
            prev_hi = j_hi;
            // left-margin cell: read by this row's E-chain / next row's diag
            if (j_lo > 1) Hn[j_lo - 1] = NEG;
        }
        scr.jlo[i] = j_lo; scr.jhi[i] = j_hi;
        uint8_t* prow = scr.packed.data() + (size_t)i * scr.band_stride - j_lo;
        Hn[0] = 0;
        // The vector loop overruns j_hi by up to 31 lanes; those cells must
        // read as "never written" afterwards (the banded window-extension
        // contract, matched bit-for-bit by the numpy/Pallas mirrors, keeps
        // whatever construction left in each double buffer there).  Save
        // and restore them around the row.
        const __m512i hn_tail = _mm512_loadu_si512(Hn + j_hi + 1);
        const __m512i f_tail = _mm512_loadu_si512(Fr + j_hi + 1);
        __m512i jext = _mm512_mullo_epi16(
            _mm512_add_epi16(_mm512_set1_epi16((int16_t)j_lo), lanes16), vgext);
        // lane 31 == the primed hne[j_lo-1]: H[i][0] = 0 inside the band,
        // NEG (unreachable) when the window starts past column 1
        __m512i prev_hne = (j_lo == 1) ? _mm512_setzero_si512() : vneg;
        __m512i prev_p = vneg;
        __m512i vcarry = vneg;                      // running T before block
        const __m256i vc1b = _mm256_set1_epi8((char)c1);
        for (int j = j_lo; j <= j_hi; j += 32) {
            __m512i Hj = _mm512_loadu_si512(H + j);
            __m512i Hm1 = _mm512_loadu_si512(H + j - 1);
            __m512i Fj = _mm512_loadu_si512(Fr + j);
            __m512i fo = _mm512_sub_epi16(Hj, vopen);
            __m512i fe = _mm512_sub_epi16(Fj, vext);
            __mmask32 fm = _mm512_cmp_epi16_mask(fo, fe, _MM_CMPINT_NLT);
            __m512i Fp = _mm512_max_epi16(fo, fe);
            _mm512_storeu_si512(Fr + j, Fp);
            // Tail-masked load: the final block may overrun j_hi by up to
            // 31 lanes and s2 rows are exactly len2 bytes (ptr-path rows and
            // the last staging row have no tail padding).  Masked-off lanes
            // read as 0; their eq bits only feed overrun cells, which are
            // restored from the saved tails / never consumed.
            const unsigned rem = (unsigned)(j_hi - j + 1);
            const __mmask32 ldm =
                rem >= 32 ? (__mmask32)~0u : (((__mmask32)1u << rem) - 1u);
            __mmask32 eq = _mm256_cmpeq_epi8_mask(
                _mm256_maskz_loadu_epi8(ldm, (const void*)(s2 + j - 1)), vc1b);
            __m512i sub = _mm512_mask_blend_epi16(eq, vmis, vmatch);
            __m512i dg = _mm512_add_epi16(Hm1, sub);
            __m512i hn = _mm512_max_epi16(dg, Fp);
            __m512i gsrc = _mm512_permutex2var_epi16(prev_hne, sh1, hn);
            __m512i gv = _mm512_add_epi16(_mm512_sub_epi16(gsrc, vopen), jext);
            __m512i pv = gv;
            for (int s = 0; s < 5; ++s)
                pv = _mm512_max_epi16(
                    pv, _mm512_mask_permutexvar_epi16(vneg, shift_msk[s],
                                                      shift_idx[s], pv));
            // finalize this block with the carry from blocks before it
            __m512i ci = vcarry;
            __m512i tex = _mm512_max_epi16(
                _mm512_permutex2var_epi16(prev_p, sh1, pv), ci);
            __mmask32 ge = _mm512_cmp_epi16_mask(gv, tex, _MM_CMPINT_NLT);
            __m512i tinc = _mm512_max_epi16(pv, ci);
            __m512i ev = _mm512_sub_epi16(tinc, jext);
            __mmask32 lm = _mm512_cmp_epi16_mask(ev, hn, _MM_CMPINT_NLE);
            __mmask32 um = _mm512_cmp_epi16_mask(Fp, dg, _MM_CMPINT_NLE);
            _mm512_storeu_si512(Hn + j, _mm512_max_epi16(hn, ev));
            __m256i mv = v1;
            mv = _mm256_mask_mov_epi8(mv, um, v2);
            mv = _mm256_mask_mov_epi8(mv, lm, v3);
            mv = _mm256_or_si256(mv, _mm256_maskz_set1_epi8(ge, 4));
            mv = _mm256_or_si256(mv, _mm256_maskz_set1_epi8(fm, 8));
            _mm256_storeu_si256((__m256i*)(prow + j), mv);
            // carry update: broadcast of pv lane 31 (block max), one
            // behind by design — stays in vector registers (no GPR trip)
            vcarry = _mm512_max_epi16(
                vcarry, _mm512_permutexvar_epi16(idx31, pv));
            prev_hne = hn;
            prev_p = pv;
            jext = _mm512_add_epi16(jext, vext32);
        }
        _mm512_storeu_si512(Hn + j_hi + 1, hn_tail);
        _mm512_storeu_si512(Fr + j_hi + 1, f_tail);
        std::swap(H, Hn);
        if (j_hi == m && H[m] >= col_best) { col_best = H[m]; col_best_i = i; }
    }
    int scan_lo = (n == 0) ? 1 : scr.jlo[n];
    int scan_hi = (n == 0) ? m : scr.jhi[n];
    int16_t row_best = H[0];
    int row_best_j = 0;
    for (int j = scan_lo; j <= scan_hi; ++j)
        if (H[j] >= row_best) { row_best = H[j]; row_best_j = j; }
    if (row_best >= col_best) {
        res->score = row_best; res->end_i = len1; res->end_j = row_best_j;
    } else {
        res->score = col_best; res->end_i = col_best_i; res->end_j = m;
    }
}
#endif  // NGSID_AVX512

// Lane-width dispatch: int16 when exactness is provable, else int32.
void dp_single(const uint8_t* s1, const uint8_t* s2,
               int len1, int len2, int gap_open,
               int match, int mismatch, int gap_ext,
               int band_hw,
               DpScratch& scr,
               PairResult* res) {
    if (fits_int16(len1, len2, match, mismatch, gap_open, gap_ext)) {
#ifdef NGSID_AVX512
        if (len2 >= 1 && len1 >= 1) {
            dp_single_fused_i16(s1, s2, len1, len2, gap_open, match,
                                mismatch, gap_ext, band_hw, scr, res);
            return;
        }
#endif
        dp_single_impl<int16_t>(s1, s2, len1, len2, gap_open, match,
                                mismatch, gap_ext, band_hw, scr, res);
    } else
        dp_single_impl<int32_t>(s1, s2, len1, len2, gap_open, match,
                                mismatch, gap_ext, band_hw, scr, res);
}

// Traceback into moves_out (caller-allocated n+m bytes); returns length.
// Reads outside a row's written window resolve to 0 via cell_at(), the same
// value the old zero-initialized full matrix held there — the optimal path
// itself never leaves the written band (NEG_INF cells cannot win a max).
int traceback(const DpScratch& scr,
              int n, int m, int end_i, int end_j, uint8_t* moves_out) {
    int pos = 0;
    // emit reversed; caller's buffer is filled back-to-front then reversed
    std::vector<uint8_t> ops;
    ops.reserve(n + m);
    for (int k = 0; k < n - end_i; ++k) ops.push_back(MV_UP);
    for (int k = 0; k < m - end_j; ++k) ops.push_back(MV_LEFT);
    int i = end_i, j = end_j, state = 0;
    while (i > 0 && j > 0) {
        uint8_t cell = scr.cell_at(i, j);
        if (state == 0) {
            uint8_t mv = cell & 3;
            if (mv == MV_DIAG) { ops.push_back(MV_DIAG); --i; --j; }
            else if (mv == MV_LEFT) state = 1;
            else state = 2;
        } else if (state == 1) {
            ops.push_back(MV_LEFT);
            if (cell & 4) state = 0;
            --j;
        } else {
            ops.push_back(MV_UP);
            if (cell & 8) state = 0;
            --i;
        }
    }
    while (i-- > 0) ops.push_back(MV_UP);
    while (j-- > 0) ops.push_back(MV_LEFT);
    pos = (int)ops.size();
    for (int k = 0; k < pos; ++k) moves_out[k] = ops[pos - 1 - k];
    return pos;
}

}  // namespace

extern "C" {

// Positions of newline bytes in data[0, n): fills out (capacity cap) and
// returns the total count.  If the count exceeds cap the caller must retry
// with a larger buffer (only the first cap positions are written).  One
// SIMD compare + mask-walk per 64 bytes.
int64_t find_newlines_native(const uint8_t* data, int64_t n,
                             int64_t* out, int64_t cap) {
    int64_t count = 0;
    int64_t i = 0;
#ifdef NGSID_AVX512
    const __m512i vnl = _mm512_set1_epi8('\n');
    for (; i + 64 <= n; i += 64) {
        __mmask64 m = _mm512_cmpeq_epi8_mask(
            _mm512_loadu_si512((const void*)(data + i)), vnl);
        while (m) {
            int b = __builtin_ctzll(m);
            if (count < cap) out[count] = i + b;
            ++count;
            m &= m - 1;
        }
    }
#endif
    for (; i < n; ++i)
        if (data[i] == '\n') {
            if (count < cap) out[count] = i;
            ++count;
        }
    return count;
}


// Homopolymer compression of a concatenated read buffer (reference
// cluster.py:265 / get_sorted:58 — itertools.groupby first-of-run).
//   flat: concatenated read bytes; bounds: n+1 read offsets into flat.
//   comp_out: capacity >= bounds[n] bytes; cb_out: n+1 compacted offsets.
// Two passes, OpenMP over reads: count runs per read, serial prefix sum,
// then fill each read's run-first bytes at its compacted offset.  Runs
// never span reads (each read restarts its own first run).
void hpol_compress_native(const uint8_t* flat, const int64_t* bounds,
                          int64_t n, uint8_t* comp_out, int64_t* cb_out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = bounds[i], e = bounds[i + 1];
        int64_t c = 0;
        if (e > s) {
            uint8_t prev = flat[s];
            c = 1;
            for (int64_t t = s + 1; t < e; ++t)
                if (flat[t] != prev) { ++c; prev = flat[t]; }
        }
        cb_out[i + 1] = c;
    }
    cb_out[0] = 0;
    for (int64_t i = 0; i < n; ++i) cb_out[i + 1] += cb_out[i];
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        int64_t s = bounds[i], e = bounds[i + 1];
        int64_t o = cb_out[i];
        if (e > s) {
            uint8_t prev = flat[s];
            comp_out[o++] = prev;
            for (int64_t t = s + 1; t < e; ++t)
                if (flat[t] != prev) { prev = flat[t]; comp_out[o++] = prev; }
        }
    }
}


// Batched DP + traceback.
//   s1b: B x n_stride bytes, s2b: B x m_stride bytes (padded)
//   moves_out: B x (n_stride + m_stride) bytes; moves_len: B
void sg_align_batch_native(
    const uint8_t* s1b, const uint8_t* s2b,
    const int32_t* len1, const int32_t* len2, const int32_t* gap_opens,
    int B, int n_stride, int m_stride,
    int match, int mismatch, int gap_ext, int band_hw,
    uint8_t* moves_out, int32_t* moves_len, int32_t* scores) {
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        DpScratch scr;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int b = 0; b < B; ++b) {
            int n = len1[b], m = len2[b];
            PairResult res;
            dp_single(s1b + (size_t)b * n_stride, s2b + (size_t)b * m_stride,
                      n, m, gap_opens[b], match, mismatch, gap_ext, band_hw,
                      scr, &res);
            moves_len[b] = traceback(scr, n, m, res.end_i, res.end_j,
                                     moves_out + (size_t)b * (n_stride + m_stride));
            scores[b] = res.score;
        }
    }
}

// Batched DP + block-alignment statistics, no move export.
// For each pair: run the DP, trace back, build the per-column match vector
// (terminal gaps included, like a parasail CIGAR) and count rolling windows
// of k columns with >= match_id matches (reference cluster.py:144-168).
// ratios[2b] = aligned / len1, ratios[2b+1] = aligned / len2.
static void block_stats_pair(
    const uint8_t* s1, const uint8_t* s2, int n, int m,
    int gap_open, int k, int match_id,
    int match, int mismatch, int gap_ext, int band_hw,
    DpScratch& scr, std::vector<uint8_t>& mv, double* out2) {
    PairResult res;
    dp_single(s1, s2, n, m, gap_open, match, mismatch, gap_ext,
              band_hw, scr, &res);
    int len = traceback(scr, n, m, res.end_i, res.end_j, scr.moves.data());
    const uint8_t* moves = scr.moves.data();
    if (len < k) { out2[0] = 0.0; out2[1] = 0.0; return; }
    // match vector + rolling window in one pass
    if ((int)mv.size() < len) mv.resize(len);
    int i = 0, j = 0;
    for (int t = 0; t < len; ++t) {
        uint8_t op = moves[t];
        if (op == MV_DIAG) { mv[t] = s1[i] == s2[j]; ++i; ++j; }
        else if (op == MV_UP) { mv[t] = 0; ++i; }
        else { mv[t] = 0; ++j; }
    }
    int window = 0, aligned = 0;
    for (int t = 0; t < k; ++t) window += mv[t];
    aligned += window >= match_id;
    for (int t = k; t < len; ++t) {
        window += mv[t] - mv[t - k];
        aligned += window >= match_id;
    }
    out2[0] = (double)aligned / n;
    out2[1] = (double)aligned / m;
}

void sg_block_stats_native(
    const uint8_t* s1b, const uint8_t* s2b,
    const int32_t* len1, const int32_t* len2, const int32_t* gap_opens,
    const int32_t* ks, const int32_t* match_ids,
    int B, int n_stride, int m_stride,
    int match, int mismatch, int gap_ext, int band_hw,
    double* ratios) {
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        DpScratch scr;
        std::vector<uint8_t> mv;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int b = 0; b < B; ++b)
            block_stats_pair(s1b + (size_t)b * n_stride,
                             s2b + (size_t)b * m_stride,
                             len1[b], len2[b], gap_opens[b],
                             ks[b], match_ids[b],
                             match, mismatch, gap_ext, band_hw,
                             scr, mv, ratios + 2 * b);
    }
}

// Pointer-row variant: sequence rows live wherever the caller's buffers
// are (s1_addr/s2_addr hold their addresses) — no padded staging copies.
void sg_block_stats_ptr_native(
    const int64_t* s1_addr, const int64_t* s2_addr,
    const int32_t* len1, const int32_t* len2, const int32_t* gap_opens,
    const int32_t* ks, const int32_t* match_ids,
    int B, int match, int mismatch, int gap_ext, int band_hw,
    double* ratios) {
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        DpScratch scr;
        std::vector<uint8_t> mv;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int b = 0; b < B; ++b)
            block_stats_pair((const uint8_t*)(uintptr_t)s1_addr[b],
                             (const uint8_t*)(uintptr_t)s2_addr[b],
                             len1[b], len2[b], gap_opens[b],
                             ks[b], match_ids[b],
                             match, mismatch, gap_ext, band_hw,
                             scr, mv, ratios + 2 * b);
    }
}

// Batched DP + column identity (reference consensus.py:129-145):
// identities[b] = matching columns / total alignment columns.
void sg_identity_native(
    const uint8_t* s1b, const uint8_t* s2b,
    const int32_t* len1, const int32_t* len2, const int32_t* gap_opens,
    int B, int n_stride, int m_stride,
    int match, int mismatch, int gap_ext, int band_hw,
    double* identities) {
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        DpScratch scr;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int b = 0; b < B; ++b) {
            int n = len1[b], m = len2[b];
            PairResult res;
            const uint8_t* s1 = s1b + (size_t)b * n_stride;
            const uint8_t* s2 = s2b + (size_t)b * m_stride;
            dp_single(s1, s2, n, m, gap_opens[b], match, mismatch, gap_ext,
                      band_hw, scr, &res);
            int len = traceback(scr, n, m, res.end_i, res.end_j,
                                scr.moves.data());
            const uint8_t* moves = scr.moves.data();
            int i = 0, j = 0, matches = 0;
            for (int t = 0; t < len; ++t) {
                uint8_t op = moves[t];
                if (op == MV_DIAG) { matches += s1[i] == s2[j]; ++i; ++j; }
                else if (op == MV_UP) ++i;
                else ++j;
            }
            identities[b] = len ? (double)matches / len : 0.0;
        }
    }
}

// Per-read error-rate statistics for the clustering store
// (cluster/store.py::_hpol_error_rate and ::_full_error_rate):
//   hpol_err[b] = count-weighted mean of the capped error probability of the
//                 best-quality char per homopolymer run (best = lowest p,
//                 ties keep the first occurrence — reference cluster.py:279-291);
//   full_err[b] = same mean over the full quality string.
// Accumulation is a sequential double sum over ascending byte values of
// counts[v] * p_table[v], the exact operation order of the numpy
// cumsum-based implementation, so results are bit-identical.
void read_error_stats_native(
    const uint8_t* seqs, const uint8_t* quals, const int32_t* lens,
    int B, int stride, const double* p_table /* 128 doubles, capped */,
    double* hpol_err, double* full_err) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int b = 0; b < B; ++b) {
        const uint8_t* s = seqs + (size_t)b * stride;
        const uint8_t* q = quals + (size_t)b * stride;
        int n = lens[b];
        int64_t full_counts[128] = {0};
        int64_t run_counts[128] = {0};
        int64_t n_runs = 0;
        int i = 0;
        while (i < n) {
            uint8_t base = s[i];
            uint8_t best_q = q[i];
            double best_p = p_table[q[i] & 0x7F];
            full_counts[q[i] & 0x7F]++;
            int j = i + 1;
            for (; j < n && s[j] == base; ++j) {
                full_counts[q[j] & 0x7F]++;
                double p = p_table[q[j] & 0x7F];
                if (p < best_p) { best_p = p; best_q = q[j]; }
            }
            run_counts[best_q & 0x7F]++;
            ++n_runs;
            i = j;
        }
        double acc_h = 0.0, acc_f = 0.0;
        for (int v = 0; v < 128; ++v) {
            acc_h += (double)run_counts[v] * p_table[v];
            acc_f += (double)full_counts[v] * p_table[v];
        }
        hpol_err[b] = n_runs ? acc_h / (double)n_runs : 0.0;
        full_err[b] = n ? acc_f / (double)n : 0.0;
    }
}

// Pileup accumulation for one center (ops/poa.py::pileup_stats, the polish
// hot loop): align every read to the fixed center (parallel DP), then walk
// the alignment cores sequentially IN READ ORDER accumulating unit votes,
// weight votes, slot coverage, and insertion events.  The sequential
// accumulation reproduces the Python walk's float-addition order exactly,
// so outputs are bit-identical; insertion runs are exported as flat events
// (position, summed weight / run length, bytes) for the host to fold into
// its per-slot dictionaries (events are ~the indel rate, far smaller than
// the move stream).
//
//   votes, qvotes: L x 5 doubles (A C G T gap); coverage: L+1 doubles
//   ev_pos/ev_w/ev_len + ev_bytes: caller-allocated, capacity = total read
//   bytes (every event consumes >= 1 read base); counts returned via n_ev /
//   n_ev_bytes.
// win_lo/win_hi: per-read center window [win_lo, win_hi) — the DP and all
// accumulation are confined to the window, with vote/coverage/event
// positions offset back to center coordinates.  Full-center behaviour
// (win_lo=0, win_hi=L for every read) is bit-identical to the unwindowed
// engine.  Terminal-extension events only fire at true center termini
// (win_lo == 0 / win_hi == L).
void sg_pileup_native(
    const uint8_t* center, int L,
    const uint8_t* reads, const int32_t* read_len, int B, int rstride,
    const int32_t* win_lo, const int32_t* win_hi,
    const double* weights, int has_weights,
    int match, int mismatch, int gap_open, int gap_ext, int band_hw,
    double* votes, double* qvotes, double* coverage,
    int32_t* ev_pos, double* ev_w, int32_t* ev_len, uint8_t* ev_bytes,
    int64_t* n_ev, int64_t* n_ev_bytes) {
    std::vector<uint8_t> moves((size_t)B * (L + rstride));
    std::vector<int32_t> mlen(B);
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        DpScratch scr;
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
        for (int b = 0; b < B; ++b) {
            int m = read_len[b];
            int wl = win_lo[b], wh = win_hi[b];
            PairResult res;
            dp_single(center + wl, reads + (size_t)b * rstride, wh - wl, m,
                      gap_open, match, mismatch, gap_ext, band_hw, scr, &res);
            mlen[b] = traceback(scr, wh - wl, m, res.end_i, res.end_j,
                                moves.data() + (size_t)b * (L + rstride));
        }
    }

    int8_t base_col[256];
    std::memset(base_col, -1, sizeof(base_col));
    base_col['A'] = 0; base_col['C'] = 1; base_col['G'] = 2; base_col['T'] = 3;
    constexpr int GAP = 4;

    int64_t ne = 0, nb = 0;
    for (int b = 0; b < B; ++b) {
        const uint8_t* mv = moves.data() + (size_t)b * (L + rstride);
        const uint8_t* read = reads + (size_t)b * rstride;
        const double* w = has_weights ? weights + (size_t)b * rstride : nullptr;
        const int wl = win_lo[b];
        const int Lw = win_hi[b] - wl;          // window length
        const bool head_terminal = wl == 0;
        const bool tail_terminal = win_hi[b] == L;
        int len = mlen[b];
        // trim to aligned core (ops/poa.py::trim_to_aligned)
        int lo = 0, hi = len;
        while (lo < len && mv[lo] != MV_DIAG) ++lo;
        if (lo == len) continue;  // no diagonal column: read does not vote
        while (mv[hi - 1] != MV_DIAG) --hi;
        int ci = 0, ri = 0;
        for (int t = 0; t < lo; ++t) {
            if (mv[t] == MV_UP) ++ci;
            else if (mv[t] == MV_LEFT) ++ri;
        }
        int span_lo = ci;
        int pend_len = 0;
        double pend_w = 0.0;
        // Terminal extension (ops/poa.py::pileup_stats): head bases of a
        // read whose alignment starts at center position 0 vote an
        // insertion event at slot 0 (tail symmetrically below).
        if (head_terminal && ci == 0 && ri > 0) {
            for (int p = 0; p < ri; ++p) {
                ev_bytes[nb++] = read[p];
                pend_w += w ? w[p] : 1.0;
            }
            ev_pos[ne] = 0;
            ev_w[ne] = pend_w / ri;
            ev_len[ne] = ri;
            ++ne;
            pend_w = 0.0;
        }
        for (int t = lo; t < hi; ++t) {
            uint8_t op = mv[t];
            if (op == MV_LEFT) {
                ev_bytes[nb++] = read[ri];
                ++pend_len;
                pend_w += w ? w[ri] : 1.0;
                ++ri;
                continue;
            }
            if (pend_len) {
                ev_pos[ne] = wl + ci;
                ev_w[ne] = pend_w / pend_len;
                ev_len[ne] = pend_len;
                ++ne;
                pend_len = 0;
                pend_w = 0.0;
            }
            if (op == MV_DIAG) {
                int8_t c = base_col[read[ri]];
                if (c >= 0) {
                    votes[(size_t)(wl + ci) * 5 + c] += 1.0;
                    qvotes[(size_t)(wl + ci) * 5 + c] += w ? w[ri] : 1.0;
                }
                ++ci; ++ri;
            } else {  // MV_UP: deletion in the read
                votes[(size_t)(wl + ci) * 5 + GAP] += 1.0;
                qvotes[(size_t)(wl + ci) * 5 + GAP] += 1.0;
                ++ci;
            }
        }
        if (pend_len) {
            ev_pos[ne] = wl + ci;
            ev_w[ne] = pend_w / pend_len;
            ev_len[ne] = pend_len;
            ++ne;
        }
        if (tail_terminal && ci == Lw && ri < read_len[b]) {
            pend_len = 0;
            pend_w = 0.0;
            for (int p = ri; p < read_len[b]; ++p) {
                ev_bytes[nb++] = read[p];
                ++pend_len;
                pend_w += w ? w[p] : 1.0;
            }
            ev_pos[ne] = L;
            ev_w[ne] = pend_w / pend_len;
            ev_len[ne] = pend_len;
            ++ne;
        }
        for (int p = wl + span_lo; p <= wl + ci; ++p) coverage[p] += 1.0;
    }
    *n_ev = ne;
    *n_ev_bytes = nb;
}

// Stage-1 per-read statistics (preprocess.py hot loop), fused in one pass:
//   scores[b]    = expected number of error-free k-mers — bit-identical to
//                  ops/score.py::batch_scores' cumprod/cumsum identity, which
//                  is itself bit-identical to the reference's sequential
//                  recurrence (get_sorted_fastq_for_cluster.py:23-33): same
//                  elementwise 1-p, same ratio division, same multiply and
//                  add order (-ffp-contract=off keeps FMA out);
//   errs[b]      = mean per-base error probability over the uncapped table,
//                  accumulated over ascending byte values
//                  (ops/score.py::batch_error_rates order);
//   hpol_lens[b] = homopolymer-compressed length (stage-1 length filter).
void stage1_stats_native(
    const uint8_t* seqs, const uint8_t* quals, const int32_t* lens,
    int B, int stride, int k,
    const double* p_capped /*128*/, const double* p_uncapped /*128*/,
    double* scores, double* errs, int32_t* hpol_lens) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int b = 0; b < B; ++b) {
        const uint8_t* s = seqs + (size_t)b * stride;
        const uint8_t* q = quals + (size_t)b * stride;
        int n = lens[b];
        // homopolymer-compressed length
        int hl = n > 0 ? 1 : 0;
        for (int i = 1; i < n; ++i) hl += s[i] != s[i - 1];
        hpol_lens[b] = hl;
        // error rate: counts, then ascending-byte weighted sum
        int64_t counts[128] = {0};
        for (int i = 0; i < n; ++i) counts[q[i] & 0x7F]++;
        double acc = 0.0;
        for (int v = 0; v < 128; ++v) {
            double term = (double)counts[v] * p_uncapped[v];
            acc += term;
        }
        errs[b] = n ? acc / (double)n : 0.0;
        // score: sequential cumprod of [w_0..w_{k-1}, w_k/w_0, ...] summed
        // from index k-1 on (the reference's sliding-window recurrence)
        if (n < k) { scores[b] = 0.0; continue; }
        double cp = 1.0;
        for (int j = 0; j < k; ++j) cp *= 1.0 - p_capped[q[j] & 0x7F];
        double sum_exp = cp;
        for (int j = k; j < n; ++j) {
            double w_new = 1.0 - p_capped[q[j] & 0x7F];
            double w_old = 1.0 - p_capped[q[j - k] & 0x7F];
            double ratio = w_new / w_old;
            cp *= ratio;
            sum_exp += cp;
        }
        double n_kmers = (double)(n - k + 1);
        double expected_err = n_kmers - sum_exp;
        double p_no_err = 1.0 - expected_err / n_kmers;
        scores[b] = p_no_err * n_kmers;
    }
}

// Lexicographic k-mer minimizers over homopolymer-compressed sequences,
// exact emission semantics of ops/minimizers.py (reference cluster.py:16-39):
// first window of w-k+1 k-mer starts (truncated/empty k-mers padded with
// rank 0), re-emit on leaving minimum (first-occurrence rescan), emit on
// strictly-smaller entering k-mer.  Requires k * rank_bits <= 62 (the
// caller falls back to the numpy path otherwise).
//   rank_of: 256 int64 byte ranks (1-based; 0 = padding)
//   out_codes/out_pos: B x stride flat; out_counts: emissions per read
static int minimizer_row(
    const uint8_t* s, int L, int k, int win,
    const int64_t* rank_of, int rank_bits,
    std::vector<int64_t>& codes, int64_t* oc, int64_t* op) {
    {
        {
            if (L < k) { return 0; }
            if ((int)codes.size() < L) codes.resize(L);
            // packed rank codes at every start position; truncated tail
            // k-mers are right-padded with rank 0 (prefix-sorts-first)
            const uint64_t mask = (k * rank_bits >= 64)
                ? ~0ULL : ((1ULL << (k * rank_bits)) - 1);
            uint64_t code = 0;
            for (int i = 0; i < k - 1; ++i)
                code = (code << rank_bits) | (uint64_t)rank_of[s[i]];
            for (int i = 0; i + k <= L; ++i) {
                code = ((code << rank_bits) | (uint64_t)rank_of[s[i + k - 1]]) & mask;
                codes[i] = (int64_t)code;
            }
            for (int i = std::max(L - k + 1, 0); i < L; ++i) {
                // truncated suffix k-mer: remaining chars, padded with 0
                uint64_t c = 0;
                for (int off = 0; off < k; ++off) {
                    uint64_t r = (i + off < L) ? (uint64_t)rank_of[s[i + off]] : 0;
                    c = (c << rank_bits) | r;
                }
                codes[i] = (int64_t)(c & mask);
            }
            int n_kmers = L - k + 1;
            int cnt = 0;
            if (n_kmers <= win) {
                // single (possibly truncated/padded) window over [0, win)
                int64_t best = (0 < L) ? codes[0] : 0;
                int best_pos = 0;
                for (int j = 1; j < win; ++j) {
                    int64_t c = (j < L) ? codes[j] : 0;
                    if (c < best) { best = c; best_pos = j; }
                }
                oc[0] = best; op[0] = best_pos;
                return 1;
            }
            // first full window
            int64_t cur = codes[0];
            int cur_pos = 0;
            for (int j = 1; j < win; ++j)
                if (codes[j] < cur) { cur = codes[j]; cur_pos = j; }
            oc[cnt] = cur; op[cnt] = cur_pos; ++cnt;
            for (int i = win; i < n_kmers; ++i) {
                int64_t leaving = codes[i - win];
                if (leaving == cur) {
                    // minimum left the window: rescan for the new minimum
                    // (re-emits even when the value is unchanged — part of
                    // the contract)
                    cur = codes[i - win + 1];
                    cur_pos = i - win + 1;
                    for (int j = i - win + 2; j <= i; ++j)
                        if (codes[j] < cur) { cur = codes[j]; cur_pos = j; }
                    oc[cnt] = cur; op[cnt] = cur_pos; ++cnt;
                } else if (codes[i] < cur) {
                    cur = codes[i]; cur_pos = i;
                    oc[cnt] = cur; op[cnt] = cur_pos; ++cnt;
                }
            }
            return cnt;
        }
    }
}

// Padded-matrix entry (rows at b*stride in/out).
void minimizers_native(
    const uint8_t* seqs, const int32_t* lens, int B, int stride,
    int k, int w, const int64_t* rank_of, int rank_bits,
    int64_t* out_codes, int64_t* out_pos, int32_t* out_counts) {
    const int win = w - k + 1;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int64_t> codes;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
        for (int b = 0; b < B; ++b)
            out_counts[b] = minimizer_row(
                seqs + (size_t)b * stride, lens[b], k, win, rank_of, rank_bits,
                codes, out_codes + (size_t)b * stride,
                out_pos + (size_t)b * stride);
    }
}

// Flat-input entry: row b spans flat[in_off[b], in_off[b+1]); outputs are
// written at base in_off[b] (counts <= row length always holds).  No
// staging copies — the whole batch is one contiguous buffer.
void minimizers_flat_native(
    const uint8_t* flat, const int64_t* in_off, int B,
    int k, int w, const int64_t* rank_of, int rank_bits,
    int64_t* out_codes, int64_t* out_pos, int32_t* out_counts) {
    const int win = w - k + 1;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<int64_t> codes;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
        for (int b = 0; b < B; ++b)
            out_counts[b] = minimizer_row(
                flat + in_off[b], (int)(in_off[b + 1] - in_off[b]), k, win,
                rank_of, rank_bits,
                codes, out_codes + in_off[b], out_pos + in_off[b]);
    }
}

// Wave decision pass (cluster/engine.py::_decide_waves): for every wave
// read, join its minimizer emissions against the two sorted CSR posting
// tables (compacted base + recent-insert delta), accumulate per-candidate
// hit count / position sum / gap-span mapped length STREAMING in emission
// order (exactly the numpy segment reduction: integer contributions, so the
// float64 bincount it replaces is bit-identical), order candidates by
// (count, sum_pos, accession rank) descending, and run the reference's
// mapping decision walk (cluster.py:67-127).  Mapping failures with
// top_hits >= min_shared emit the tied-top candidates for the alignment
// fallback, in candidate order.
//
// Outputs: decisions[i] = rep id or -1; nr_shared[i] = top hit count (0 when
// no candidates); cand_off (n_wave+1) + cand_flat = per-read fallback
// candidate lists.  Returns 0 on success, or the required cand_flat
// capacity when cand_cap is too small (caller retries; nothing written).
int64_t decide_wave_native(
    const int64_t* codes, const int64_t* pos, const int64_t* roff,
    const int64_t* wave_rows, const int64_t* wave_ids, int n_wave,
    const int64_t* base_codes, const int64_t* base_off,
    const int64_t* base_posts, int64_t n_base,
    const int64_t* d_codes, const int64_t* d_off,
    const int64_t* d_posts, int64_t n_delta,
    const int64_t* row_of_id,
    const int8_t* eidx, const int64_t* hpol_len, const int64_t* acc_rank,
    const int64_t* gmax /* 15 x 15 */,
    int min_shared, double min_fraction, double mapped_threshold,
    int symmetric,
    const int64_t* bidx /* 65537 bucket starts over base_codes, or null */,
    int bidx_shift,
    int64_t* decisions, int64_t* nr_shared,
    int64_t* cand_flat, int64_t cand_cap, int64_t* cand_off) {
    struct Cand {
        int64_t rep;
        int64_t count;
        int64_t sum_pos;
        int64_t mapped;
        int64_t prev_mi;
        int64_t prev_pos;
        int64_t last_mi;   // == prev_mi after updates; kept for clarity
        int64_t gmax_rc;
        int64_t rep_row;
    };
    std::vector<std::vector<int64_t>> cand_lists((size_t)n_wave);

#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<Cand> cands;
        std::vector<int32_t> order;
        // per-thread hash: rep id -> candidate slot (open addressing, pow2
        // size).  Generation stamps make per-read reuse free — a slot is
        // live iff hgen[h] == gen, so no clearing between reads (the
        // per-read vector construction was the dominant cost of this pass).
        size_t hcap = 1024;
        std::vector<int64_t> hkey(hcap);
        std::vector<int32_t> hval(hcap);
        std::vector<uint32_t> hgen(hcap, 0);
        uint32_t gen = 0;
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
        for (int i = 0; i < n_wave; ++i) {
            decisions[i] = -1;
            nr_shared[i] = 0;
            const int64_t self_id = wave_ids[i];
            const int64_t read_row = wave_rows[i];
            const int8_t e_read = eidx[read_row];
            const int64_t n_min = roff[i + 1] - roff[i];
            cands.clear();
            if (++gen == 0) {           // stamp wrap: hard reset
                std::fill(hgen.begin(), hgen.end(), 0u);
                gen = 1;
            }
            auto grow = [&]() {
                size_t ncap = hcap * 2;
                std::vector<int64_t> nk(ncap);
                std::vector<int32_t> nv(ncap);
                std::vector<uint32_t> ng(ncap, 0);
                for (size_t s = 0; s < hcap; ++s) {
                    if (hgen[s] != gen) continue;
                    size_t h = (size_t)(hkey[s] * 0x9E3779B97F4A7C15ULL) & (ncap - 1);
                    while (ng[h] == gen) h = (h + 1) & (ncap - 1);
                    nk[h] = hkey[s]; nv[h] = hval[s]; ng[h] = gen;
                }
                hkey.swap(nk); hval.swap(nv); hgen.swap(ng); hcap = ncap;
            };
            auto hit = [&](int64_t rep, int64_t mi, int64_t p) {
                if (rep == self_id) return;
                size_t h = (size_t)(rep * 0x9E3779B97F4A7C15ULL) & (hcap - 1);
                while (hgen[h] == gen && hkey[h] != rep) h = (h + 1) & (hcap - 1);
                int32_t ci;
                if (hgen[h] != gen) {
                    if (cands.size() * 2 >= hcap) {
                        grow();
                        h = (size_t)(rep * 0x9E3779B97F4A7C15ULL) & (hcap - 1);
                        while (hgen[h] == gen && hkey[h] != rep) h = (h + 1) & (hcap - 1);
                    }
                    hkey[h] = rep;
                    hgen[h] = gen;
                    ci = (int32_t)cands.size();
                    hval[h] = ci;
                    Cand c;
                    c.rep = rep;
                    c.rep_row = row_of_id[rep];
                    c.count = 0; c.sum_pos = 0; c.mapped = 0;
                    c.prev_mi = -1; c.prev_pos = 0; c.last_mi = -1;
                    c.gmax_rc = gmax[(size_t)e_read * 15 + eidx[c.rep_row]];
                    cands.push_back(c);
                } else {
                    ci = hval[h];
                }
                Cand& c = cands[ci];
                // gap-span mapped accumulation (numpy _mapping_stats):
                // first hit: gap = mi, contrib = p; later: gap = mi-prev-1,
                // contrib = p - prev_pos
                int64_t gap = (c.prev_mi < 0) ? mi : mi - c.prev_mi - 1;
                int64_t contrib = (c.prev_mi < 0) ? p : p - c.prev_pos;
                if (gap <= c.gmax_rc) c.mapped += contrib;
                c.prev_mi = mi; c.prev_pos = p; c.last_mi = mi;
                c.count += 1;
                c.sum_pos += p;
            };
            for (int64_t t = roff[i]; t < roff[i + 1]; ++t) {
                const int64_t code = codes[t];
                const int64_t mi = t - roff[i];
                const int64_t p = pos[t];
                if (n_base) {
                    // top-16-bit radix bucket (host-built at compaction)
                    // narrows the search to ~4 entries: the full-range
                    // lower_bound's upper levels were the cache-missy part
                    // of this pass at 1M-read base sizes
                    const int64_t* first = base_codes;
                    const int64_t* last = base_codes + n_base;
                    if (bidx) {
                        // probe codes are unbounded by the BASE max the
                        // shift was derived from; clamp to the last bucket
                        // (its range ends at n_base, so an oversized code
                        // simply finds no match there)
                        int64_t b = (int64_t)((uint64_t)code >> bidx_shift);
                        if (b > 65535) b = 65535;
                        first = base_codes + bidx[b];
                        last = base_codes + bidx[b + 1];
                    }
                    const int64_t* lo = std::lower_bound(first, last, code);
                    if (lo != last && *lo == code) {
                        int64_t ci = lo - base_codes;
                        for (int64_t q = base_off[ci]; q < base_off[ci + 1]; ++q)
                            hit(base_posts[q], mi, p);
                    }
                }
                if (n_delta) {
                    const int64_t* lo = std::lower_bound(
                        d_codes, d_codes + n_delta, code);
                    if (lo != d_codes + n_delta && *lo == code) {
                        int64_t ci = lo - d_codes;
                        for (int64_t q = d_off[ci]; q < d_off[ci + 1]; ++q)
                            hit(d_posts[q], mi, p);
                    }
                }
            }
            if (cands.empty()) continue;
            // tail span + ratios
            const double l_comp = (double)hpol_len[read_row];
            order.resize(cands.size());
            for (size_t c = 0; c < cands.size(); ++c) {
                Cand& cd = cands[c];
                int64_t tail_gap = n_min - cd.last_mi - 1;
                if (tail_gap <= cd.gmax_rc)
                    cd.mapped += hpol_len[read_row] - cd.prev_pos;
                order[c] = (int32_t)c;
            }
            // (count, sum_pos, acc_rank) descending — unique total order
            std::sort(order.begin(), order.end(),
                      [&](int32_t a, int32_t b) {
                          const Cand& x = cands[a];
                          const Cand& y = cands[b];
                          if (x.count != y.count) return x.count > y.count;
                          if (x.sum_pos != y.sum_pos) return x.sum_pos > y.sum_pos;
                          return acc_rank[x.rep_row] > acc_rank[y.rep_row];
                      });
            const int64_t top = cands[order[0]].count;
            nr_shared[i] = top;
            int64_t decision = -1;
            if (top >= min_shared) {
                for (size_t t = 0; t < order.size(); ++t) {
                    const Cand& c = cands[order[t]];
                    if ((double)c.count < min_fraction * (double)top
                        || c.count < min_shared)
                        break;
                    double r1 = (double)c.mapped / l_comp;
                    bool ok;
                    if (symmetric) {
                        double r2 = (double)c.mapped / (double)hpol_len[c.rep_row];
                        ok = (r1 < r2 ? r1 : r2) > mapped_threshold;
                    } else {
                        ok = r1 > mapped_threshold;
                    }
                    if (ok) { decision = c.rep; break; }
                }
            }
            decisions[i] = decision;
            if (decision < 0 && top >= min_shared) {
                std::vector<int64_t>& out = cand_lists[i];
                for (size_t t = 0; t < order.size(); ++t) {
                    if (cands[order[t]].count < top) break;
                    out.push_back(cands[order[t]].rep);
                }
            }
        }
    }
    int64_t total = 0;
    for (int i = 0; i < n_wave; ++i) total += (int64_t)cand_lists[i].size();
    if (total > cand_cap) return total;
    int64_t off = 0;
    for (int i = 0; i < n_wave; ++i) {
        cand_off[i] = off;
        for (int64_t r : cand_lists[i]) cand_flat[off++] = r;
    }
    cand_off[n_wave] = off;
    return 0;
}

}  // extern "C"
