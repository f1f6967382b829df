// Banded semi-global Gotoh DP that carries alignment-path statistics forward.
//
// Replaces the TPU kernel ngspeciesid_tpu/ops/align_stats_pallas.py
// (_stats_kernel, launched by _pallas_stats) with the same int32 semantics:
// for each pair it returns the 16 int32 of the last-row and last-column
// endpoint trackers [score, coord, hist, wsum, wcount, mcount, colcount,
// diagonal] that ops/align_stats.py::_gather_chunk turns into the
// aligned-region ratios and the column identity.
//
// What bounds it on an H100: the instructions each thread issues per
// anti-diagonal, over a chain of len1 + len2 dependent diagonals per pair;
// at 4096 pairs the SMs' issue rate of the ~50 integer operations per cell.
// Not memory (a few bytes per pair in and out) and nothing for tensor
// cores.  The sweep is wavefront.cuh's: the window's lanes in registers,
// L = 2 or 4 lanes per thread, one or a few warps per pair, neighbour cells
// by warp shuffles, no block barrier per diagonal; windows too wide for one
// block's registers run the same recurrence from a global scratch slab
// (memory mode).
//
// The cell: H, E and F each carry a score and the path fields hist (last-k
// match bits), wcount (windows with >= match_id matches), mcount (matches)
// and the path's diagonal steps nd.  The TPU kernel's colcount (alignment
// columns, leading gaps included) is d - nd for a cell on diagonal d: a
// diagonal step adds one column over two diagonals, a gap step one over
// one, and a boundary cell (i + j = d leading gaps) has nd = 0; the
// unreachable cell of diagonal d, (NEG, 0, 0, 0, colcount 0), has nd = d.
// So a gap push leaves mcount and nd alone, and chunks with d_max < 32768
// pack them into one word, nd << 16 | mcount.  The TPU kernel's wsum is
// popcount(hist) (both start at 0, and every push shifts one bit out of and
// one into the k-bit window).  Scores stay int32 and E/F are not clamped,
// as in the TPU's int32 path.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (ops/cuda_lib.py), loaded with ctypes.

#include "wavefront.cuh"

namespace {

using wf::kNeg;

// mcount and nd of a path: packed (nd << 16 | mcount; nd < 32768 and
// mcount < 65536) or apart.
template <bool kPacked>
struct Steps;

template <>
struct Steps<true> {
  int md;
  __device__ static Steps make(int mc, int nd) { return Steps{nd * 65536 + mc}; }
  __device__ int mc() const { return md & 0xffff; }
  __device__ int nd() const { return md >> 16; }
  __device__ void diagonal(int bit) { md += 65536 + bit; }
  // "colcount >= k" on diagonal dd: nd < dd - k + 1
  __device__ static int limit(int dd, int k) { return (dd - k + 1) * 65536; }
  __device__ bool cols_ok(int lim) const { return md < lim; }
  template <class F>
  __device__ Steps map(F f) const { return Steps{f(md)}; }
  __device__ Steps pick(bool c, const Steps& o) const {
    return Steps{c ? md : o.md};
  }
  __device__ static Steps load(const int* buf, int W, int l) {
    return Steps{buf[3 * W + l]};
  }
  __device__ void store(int* buf, int W, int l) const { buf[3 * W + l] = md; }
  static constexpr int kInts = 1;
};

template <>
struct Steps<false> {
  int m, n;
  __device__ static Steps make(int mc, int nd) { return Steps{mc, nd}; }
  __device__ int mc() const { return m; }
  __device__ int nd() const { return n; }
  __device__ void diagonal(int bit) {
    m += bit;
    n += 1;
  }
  __device__ static int limit(int dd, int k) { return dd - k + 1; }
  __device__ bool cols_ok(int lim) const { return n < lim; }
  template <class F>
  __device__ Steps map(F f) const { return Steps{f(m), f(n)}; }
  __device__ Steps pick(bool c, const Steps& o) const {
    return Steps{c ? m : o.m, c ? n : o.n};
  }
  __device__ static Steps load(const int* buf, int W, int l) {
    return Steps{buf[3 * W + l], buf[4 * W + l]};
  }
  __device__ void store(int* buf, int W, int l) const {
    buf[3 * W + l] = m;
    buf[4 * W + l] = n;
  }
  static constexpr int kInts = 2;
};

template <bool kPacked>
struct StatsCell {
  int s, h, wc;
  Steps<kPacked> st;
};

template <bool kPacked>
struct StatsK {
  using Cell = StatsCell<kPacked>;
  using St = Steps<kPacked>;
  static constexpr int kFields = 3 + St::kInts;
  static constexpr bool kMoves = false;
  static constexpr bool kFixed = false;

  int gopen, gap_ext, match, mismatch, k, mid;
  unsigned one;  // the newest hist bit: hist is kept in the top k bits
  bool wc_on;    // a leading gap column counts as a window (match_id <= 0)

  __device__ StatsK(const wf::Launch& a, const wf::Pair& p)
      : gopen(p.gopen), gap_ext(a.gap_ext), match(a.match),
        mismatch(a.mismatch), k(p.k), mid(p.mid),
        one(1u << (32 - p.k)), wc_on(p.mid <= 0) {}

  // the unreachable cell of diagonal dd: colcount 0
  __device__ static Cell neg(int dd) {
    return Cell{kNeg, 0, 0, St::make(0, dd)};
  }
  __device__ static Cell origin() { return Cell{0, 0, 0, St::make(0, 0)}; }
  __device__ static int score(const Cell& c) { return c.s; }

  // the cell of lane + 1 (from_right) or lane - 1 (from_left) of the warp
  __device__ static Cell from_right(const Cell& c) {
    auto f = [](int v) { return __shfl_down_sync(wf::kFull, v, 1); };
    return Cell{f(c.s), f(c.h), f(c.wc), c.st.map(f)};
  }
  __device__ static Cell from_left(const Cell& c) {
    auto f = [](int v) { return __shfl_up_sync(wf::kFull, v, 1); };
    return Cell{f(c.s), f(c.h), f(c.wc), c.st.map(f)};
  }

  // memory mode: field f of lane l at buf[f * W + l]; outside the window
  // a predecessor of diagonal dd is neg(dd)
  __device__ static Cell load(const int* buf, int W, int l, int dd) {
    if (l < 0 || l >= W) return neg(dd);
    return Cell{buf[l], buf[W + l], buf[2 * W + l], St::load(buf, W, l)};
  }
  __device__ static void store(int* buf, int W, int l, const Cell& c) {
    buf[l] = c.s;
    buf[W + l] = c.h;
    buf[2 * W + l] = c.wc;
    c.st.store(buf, W, l);
  }

  __device__ int diag_ctx(int dd) const { return St::limit(dd, k); }

  // One alignment column with match bit `bit` (_push_column): shift the
  // k-bit match history (bits 32-k..31 of h, so the oldest bit falls off
  // the top), count the window if the path has >= k columns (`lim`,
  // diag_ctx of the cell's diagonal) and >= mid matches in it.
  __device__ void push(Cell& c, bool bit, int lim) const {
    const unsigned h2 = (static_cast<unsigned>(c.h) << 1) + (bit ? one : 0u);
    c.h = static_cast<int>(h2);
    c.wc += (c.st.cols_ok(lim) && __popc(h2) >= mid) ? 1 : 0;
  }

  __device__ static Cell pick(bool cond, const Cell& a, const Cell& b) {
    return Cell{cond ? a.s : b.s, cond ? a.h : b.h, cond ? a.wc : b.wc,
                a.st.pick(cond, b.st)};
  }

  // The cell from its predecessors: (i, j-1) as hl/el, (i-1, j) as hu/fu,
  // (i-1, j-1) as g2; the traceback's tie-breaks (diag > up > left, a gap
  // opens on >=) pick whose path statistics it carries.  Outside the band
  // H's score is NEG and its path fields stay as computed.
  __device__ void cell(const Cell& hl, const Cell& el, const Cell& hu,
                       const Cell& fu, const Cell& g2, bool ismatch,
                       bool valid, int lim, Cell& h, Cell& e, Cell& f,
                       unsigned& mv) const {
    const int e_open = hl.s - gopen;
    const int e_ext = el.s - gap_ext;
    e = pick(e_open >= e_ext, hl, el);
    e.s = max(e_open, e_ext);
    push(e, false, lim);
    const int f_open = hu.s - gopen;
    const int f_ext = fu.s - gap_ext;
    f = pick(f_open >= f_ext, hu, fu);
    f.s = max(f_open, f_ext);
    push(f, false, lim);
    Cell g = g2;
    g.s += ismatch ? match : mismatch;
    g.st.diagonal(ismatch ? 1 : 0);
    push(g, ismatch, lim);
    const int h_no_e = max(g.s, f.s);
    h = pick(e.s > h_no_e, e, pick(f.s > g.s, f, g));
    if (!valid) h.s = kNeg;
    mv = 0;
  }

  // A boundary cell (i == 0 or j == 0) restarts the path: i + j = dd
  // leading gap columns.
  __device__ Cell boundary(int dd) const {
    return Cell{0, 0, wc_on ? max(dd - k + 1, 0) : 0, St::make(0, 0)};
  }

  // The pair's row: the tracker whose (score, diagonal) is the pair's
  // maximum writes its payload; with no candidate thread 0 writes the
  // initial tracker (NEG, -1, 0, ...).
  __device__ void finish(const wf::Launch& a, const wf::Pair& p,
                         unsigned long long krow, unsigned long long kcol,
                         const wf::Track<Cell>& row,
                         const wf::Track<Cell>& col, int, int,
                         uint8_t*) const {
    int* o = a.out + static_cast<size_t>(p.b) * 16;
    write(o, row, krow, p.len1, p.tp, k);
    write(o + 8, col, kcol, p.len2, p.tp, k);
  }

  __device__ static void write(int* o, const wf::Track<Cell>& t,
                               unsigned long long best, int len, int tp,
                               int k) {
    if (best == 0ull) {
      if (tp == 0) {
        o[0] = kNeg;
        o[1] = -1;
        for (int f = 2; f < 8; ++f) o[f] = 0;
      }
      return;
    }
    if (t.key() != best) return;
    o[0] = t.c.s;
    o[1] = t.d - len;   // row tracker: j = d - len1; column: i = d - len2
    o[2] = static_cast<int>(static_cast<unsigned>(t.c.h) >> (32 - k));
    o[3] = __popc(static_cast<unsigned>(t.c.h));
    o[4] = t.c.wc;
    o[5] = t.c.st.mc();
    o[6] = t.d - t.c.st.nd();
    o[7] = t.d;
  }
};

// d_max below which mcount and nd share a word
constexpr int kPackedDmax = 32768;

}  // namespace

extern "C" {

// int32 of global scratch one pair needs in memory mode at window width W
// (the unpacked cell: enough for either).
int ngsid_stats_state_ints(int W) {
  return wf::kBuffers * StatsK<false>::kFields * W;
}

// Launches the stats DP of B pairs on `stream`: lanes per thread (2 or 4;
// memory == 0) or memory mode (memory == 1, lanes 1, warps 8, pairs 1,
// scratch of B * ngsid_stats_state_ints(W) int32), `warps` warps per pair
// and `pairs` pairs per block (ops/cuda_lib.py::launch_geometry).
// d_max >= max(len1 + len2).  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a geometry the kernel does not take.
int ngsid_stats_launch(const void* pool, const void* pm, const void* base,
                       void* out, void* scratch, int B, int W, int d_max,
                       int band, int match, int mismatch, int gap_ext,
                       int lanes, int warps, int pairs, int memory,
                       void* stream) {
  wf::Launch a{};
  a.pool = static_cast<const uint8_t*>(pool);
  a.pm = static_cast<const long long*>(pm);
  a.base = static_cast<const int*>(base);
  a.out = static_cast<int*>(out);
  a.scratch = static_cast<int*>(scratch);
  a.B = B;
  a.W = W;
  a.dmax = d_max;
  a.band = band;
  a.match = match;
  a.mismatch = mismatch;
  a.gap_ext = gap_ext;
  a.nw = warps;
  a.pairs = pairs;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d_max < kPackedDmax
             ? wf::launch<StatsK<true>, 2, 4>(a, lanes, memory, 0, s)
             : wf::launch<StatsK<false>, 2, 4>(a, lanes, memory, 0, s);
}

const char* ngsid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
