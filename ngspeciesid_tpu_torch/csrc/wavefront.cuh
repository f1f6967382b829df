// The banded anti-diagonal wavefront shared by stats_kernel.cu,
// moves_kernel.cu and full_dp_kernel.cu: a semi-global Gotoh DP per pair,
// swept one anti-diagonal at a time through a window of W lanes whose
// origin base[d] the host schedules per chunk
// (ops/align_stats.py::_window_schedule; band 0 is the exact full DP).
// Lane l of diagonal d holds cell (i, j) = (base[d] + l, d - i).  Each
// kernel supplies a policy K: its cell type (K::Cell), the recurrence of one
// cell (K::cell), the boundary cell (K::boundary), what it does at the end
// of a pair (K::finish), and whether its frame is fixed (K::kFixed: base 0
// on every diagonal and band 0, known at compile time, so the sweep reads
// no schedule, computes no band bounds and instantiates only the unshifted
// step; the window must then cover rows 0..len1 of every pair).
//
// What bounds the sweep on an H100: neither bytes nor operations.  A pair
// is a chain of len1 + len2 diagonals, each depending on the two before
// it, so the time is the instructions a thread issues per diagonal times
// the diagonals, over the warps an SM can interleave.  The design keeps
// both the chain and the instructions per cell short:
//
//   * Registers, not shared memory (register mode).  A pair is one or a
//     few warps; thread t of the pair owns the L contiguous lanes
//     [t*L, t*L + L) and keeps their H, E and F of d-1 in registers, and H
//     of d-2 re-framed to d-1's window (G below).  A cell's predecessors sit
//     in its own lane or one lane over (base moves by 0 or 1 lane per
//     diagonal), so a thread needs one boundary cell of one neighbour per
//     array: __shfl_down_sync / __shfl_up_sync inside a warp, and between
//     the warps of a pair a double-buffered edge slot in shared memory and
//     a named barrier of that pair's warps only (bar.sync id, 32*warps).  A
//     one-warp pair never waits at a barrier.  No __syncthreads runs per
//     diagonal.
//   * The frame shift is a template argument.  base is shared by every
//     pair of the launch, so d1 = base[d] - base[d-1] in {0, 1} is uniform
//     across the card; one branch per diagonal enters the step instantiated
//     for it, whose register choices are all fixed at compile time (no
//     dynamic register indexing, no select per cell).  H of d-2 is kept in
//     d-1's frame (G[l] = H(d-2)[l + d1(d-1)], shifted at the end of each
//     step), so the step needs only d1, not the shift of the diagonal
//     before, and one halo per diagonal: d1 = 1 the right neighbour's first
//     H and E, d1 = 0 the left neighbour's last H and F.
//   * Bases in registers.  Each lane carries the s1 base of its row and the
//     s2 base of its column (256 and 257 outside the matrix, so one compare
//     is the match bit).  A row keeps its s1 base and a column its s2 base
//     from diagonal to diagonal: d1 = 1 moves the rows down one lane, d1 =
//     0 moves the columns up one, so a step shuffles one base per thread
//     and the warp's edge thread reads one byte, fetched a diagonal ahead.
//   * The schedule as bits: base[d] - base[d-1], read by each warp 32
//     diagonals at a time as one ballot, its loads issued two chunks ahead,
//     so no load of base lies on the chain of diagonals.
//   * Boundary cells (i == 0 or j == 0) lie in at most two lanes of a
//     diagonal: a branch taken by the threads that hold one sets them.
//   * Endpoint trackers in registers: a thread offers the last-row and
//     last-column cells of its own lanes with ">=" in diagonal order; at
//     the end one shared-memory atomicMax per tracker and pair picks the
//     maximal (score, diagonal), the sequential ">=" running maximum.
//   * Memory mode, for windows too wide for the registers of one block
//     (band 0 on long reads): one pair per block of kMemThreads threads,
//     lanes strided over the threads, the state in rotating per-diagonal
//     buffers (H x3, E x2, F x2) in a global scratch slab, a named barrier
//     per diagonal.  Same recurrence, same results.
//
// Precondition (the window schedule's invariant): base is non-decreasing
// with steps of 0 or 1 and base[0] == 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wf {

constexpr int kNeg = -(1 << 30);           // ops/align.py NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlockThreads = 512;      // threads per block at most
// __launch_bounds__ of an instantiation: 256 threads (255 registers) for
// the stats kernel at 4 lanes per thread, else kMaxBlockThreads (128)
template <class K, int L>
constexpr int block_threads() {
  return (!K::kMoves && L >= 4) ? 256 : kMaxBlockThreads;
}
constexpr int kMaxWarps = kMaxBlockThreads / 32;
constexpr int kMaxPairs = 16;              // pairs per block
constexpr int kMemThreads = 256;           // memory mode: threads per pair
constexpr int kBuffers = 7;                // memory mode: H x3, E x2, F x2
constexpr int kNoRow = 256;                // s1 base of a row outside 1..len1
constexpr int kNoCol = 257;                // s2 base of a column outside 1..len2

// What every pair of a launch shares.
struct Launch {
  const uint8_t* pool;
  const long long* pm;   // (B, 8) [len1, len2, gap_open, k, match_id, off1, off2, 0]
  const int* base;       // window origin per diagonal (unread: fixed frame)
  int* out;              // stats: (B, 16) rows; moves: (B, 16) best
  uint8_t* store;        // moves: (B, dmax + 1, W) move bytes
  uint8_t* ops;          // moves: (B, dpad) op streams, zeroed by the caller
  int* scratch;          // memory mode: B slabs of kBuffers * fields * W ints
  int B, W, dmax, dpad, band, match, mismatch, gap_ext;
  int nw;                // warps per pair
  int pairs;             // pairs per block
  int seg;               // bytes of dynamic shared memory per pair (K's own)
  int trace;             // moves: 1 runs the traceback (0: the sweep alone)
};

// One pair's constants, as one thread of it sees them.
struct Pair {
  int b, len1, len2, gopen, k, mid;
  int tot;       // len1 + len2
  const uint8_t* s1;
  const uint8_t* s2;
  int tp;        // thread index within the pair
  int nthreads;  // threads of the pair
  int bar;       // named barrier id of the pair (1 + pair in block)
};

__device__ __forceinline__ void pair_sync(const Pair& p) {
  if (p.nthreads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(p.bar), "r"(p.nthreads) : "memory");
  }
}

// The s1 base of row r and the s2 base of column c, or the sentinels.
__device__ __forceinline__ int row_base(const Pair& p, int r) {
  return (r >= 1 && r <= p.len1) ? static_cast<int>(__ldg(p.s1 + r - 1))
                                 : kNoRow;
}
__device__ __forceinline__ int col_base(const Pair& p, int c) {
  return (c >= 1 && c <= p.len2) ? static_cast<int>(__ldg(p.s2 + c - 1))
                                 : kNoCol;
}

// The band test (j - band) * len1 <= i * len2 <= (j + band + 1) * len1 - 1
// with j = d - i reads ceil(X / tot) <= i <= floor(Y / tot) for
// X = (d - band) * len1, Y = (d + band + 1) * len1 - 1 and tot = len1 + len2.
// Both grow by len1 < tot per diagonal, so their quotients and remainders
// carry from one diagonal to the next with one compare each, no division.
struct Band {
  int qa, ra;  // X = qa * tot - ra, 0 <= ra < tot: ceil(X / tot) = qa
  int qb, rb;  // Y = qb * tot + rb, 0 <= rb < tot: floor(Y / tot) = qb
  __device__ __forceinline__ void init(const Pair& p, int band, int dd) {
    const long long tot = p.tot;
    const long long X = static_cast<long long>(dd - band) * p.len1;
    const long long Y = static_cast<long long>(dd + band + 1) * p.len1 - 1;
    const long long qa_ = X >= 0 ? (X + tot - 1) / tot : -((-X) / tot);
    const long long qb_ = Y >= 0 ? Y / tot : -((-Y + tot - 1) / tot);
    qa = static_cast<int>(qa_);
    ra = static_cast<int>(qa_ * tot - X);
    qb = static_cast<int>(qb_);
    rb = static_cast<int>(Y - qb_ * tot);
  }
  __device__ __forceinline__ void next(const Pair& p) {
    ra -= p.len1;
    if (ra < 0) {
      ra += p.tot;
      ++qa;
    }
    rb += p.len1;
    if (rb >= p.tot) {
      rb -= p.tot;
      ++qb;
    }
  }
};

// Where one diagonal's cells lie, as rows i:
//   an interior cell inside the band:  [v_lo, v_lo + v_n)
//   a boundary cell: i == top (cell (0, d), d <= len2) or i == left
//   (cell (d, 0), d <= len1); -1 matches no row.
struct Diag {
  int dd, bs;
  int v_lo, v_n, top, left;
};

__device__ __forceinline__ Diag diag(const Pair& p, const Band& bd, int band,
                                     int dd, int bs) {
  Diag g;
  g.dd = dd;
  g.bs = bs;
  const int in_lo = max(1, dd - p.len2);
  const int in_hi = min(p.len1, dd - 1);
  g.v_lo = band > 0 ? max(in_lo, bd.qa) : in_lo;
  g.v_n = max((band > 0 ? min(in_hi, bd.qb) : in_hi) - g.v_lo + 1, 0);
  g.top = dd <= p.len2 ? 0 : -1;
  g.left = dd <= p.len1 ? dd : -1;
  return g;
}

// A running ">=" maximum over the cells a thread offers, in diagonal order.
template <class Cell>
struct Track {
  Cell c;
  int s, d;
  bool ok;
  __device__ __forceinline__ void offer(const Cell& h, int score, int dd) {
    if (score >= kNeg && (!ok || score >= s)) {
      c = h;
      s = score;
      d = dd;
      ok = true;
    }
  }
  // (score, diagonal) as one ordered unsigned key; 0 means no cell
  __device__ unsigned long long key() const {
    if (!ok) return 0ull;
    return (static_cast<unsigned long long>(static_cast<unsigned>(s) ^
                                            0x80000000u) << 32) |
           static_cast<unsigned>(d);
  }
};

__device__ __forceinline__ int key_score(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(key >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ int key_diag(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffu);
}

// a[idx], or the halo cell outside [0, L); idx is a compile-time constant
// once the caller's loop is unrolled.
template <int L, class C>
__device__ __forceinline__ C at(const C (&a)[L], int idx, const C& halo) {
  return (idx < 0 || idx >= L) ? halo : a[idx < 0 ? 0 : (idx >= L ? L - 1 : idx)];
}

template <class Cell>
struct Edge {
  Cell h, x;  // first lanes: H and E; last lanes: H and F
};

template <class K>
struct Shared {
  Edge<typename K::Cell> first[2][kMaxWarps];
  Edge<typename K::Cell> last[2][kMaxWarps];
  unsigned long long keys[kMaxPairs][2];  // row, column
};

// Register mode: the thread's L lanes at diagonal d-1 (H1, E1, F1), H of
// d-2 in d-1's frame (G) and the left neighbour's last G (gprev); the s1
// base of each lane's row (b1) and the s2 base of its column (b2).
template <class K, int L>
struct Lanes {
  using Cell = typename K::Cell;
  Cell H1[L], E1[L], F1[L], G[L];
  Cell gprev;
  int b1[L], b2[L];
};

// The base that the warp's edge thread takes in at diagonal dd (window
// origin bs, shift d1): d1 = 1, lane 31's top lane gets a new row; d1 = 0,
// lane 0's first lane gets a new column.  Other threads return 0.
template <int L>
__device__ __forceinline__ int edge_base(const Pair& p, int w, int lane,
                                         int dd, int bs, int d1) {
  const int r = d1 ? bs + (w * 32 + 31) * L + L - 1 : dd - (bs + w * 32 * L);
  const int n = d1 ? p.len1 : p.len2;
  const uint8_t* src = d1 ? p.s1 : p.s2;
  int v = d1 ? kNoRow : kNoCol;
  if (lane == (d1 ? 31 : 0) &&
      static_cast<unsigned>(r - 1) < static_cast<unsigned>(n)) {
    v = __ldg(src + r - 1);
  }
  return v;
}

// The window schedule as bits, base[d] - base[d-1] for d >= 1, read by a
// warp 32 diagonals at a time: lane t of chunk c holds diagonal 32c + 1 + t.
// The loads of a chunk are issued two chunks before its ballot.
struct Schedule {
  unsigned cur, next;   // bits of chunks c and c + 1
  int v1, v0;           // this lane's base[] pair of chunk c + 2
  __device__ __forceinline__ static void fetch(const Launch& a, int D, int c,
                                               int lane, int& v1, int& v0) {
    const int d = 32 * c + 1 + lane;
    v1 = __ldg(a.base + min(d, D));
    v0 = __ldg(a.base + min(d - 1, D));
  }
  __device__ __forceinline__ void init(const Launch& a, int D, int lane) {
    int x1, x0;
    fetch(a, D, 0, lane, x1, x0);
    cur = __ballot_sync(kFull, x1 != x0);
    fetch(a, D, 1, lane, x1, x0);
    next = __ballot_sync(kFull, x1 != x0);
    fetch(a, D, 2, lane, v1, v0);
  }
  // at the first diagonal of chunk c >= 1
  __device__ __forceinline__ void advance(const Launch& a, int D, int c,
                                          int lane) {
    cur = next;
    next = __ballot_sync(kFull, v1 != v0);
    fetch(a, D, c + 2, lane, v1, v0);
  }
  // the shifts of diagonals dd (bit 0) and dd + 1 (bit 1)
  __device__ __forceinline__ unsigned shifts(int dd) const {
    const unsigned long long m =
        (static_cast<unsigned long long>(next) << 32) | cur;
    return static_cast<unsigned>(m >> ((dd - 1) & 31)) & 3u;
  }
};

template <class K, int L>
__device__ __forceinline__ void publish(const Launch& a, Shared<K>& sh,
                                        const Lanes<K, L>& s, int dd, int warp,
                                        int lane, bool first, bool last) {
  if (first && lane == 0) {
    sh.first[dd & 1][warp] = Edge<typename K::Cell>{s.H1[0], s.E1[0]};
  }
  if (last && lane == 31) {
    sh.last[dd & 1][warp] = Edge<typename K::Cell>{s.H1[L - 1], s.F1[L - 1]};
  }
}

// One diagonal of register mode with shift D1; eb is the edge base of this
// diagonal, d1n the shift of the next one (which edge to publish).
template <class K, int L, int D1>
__device__ __forceinline__ void reg_step(
    const K& k, const Launch& a, const Pair& p, const Diag& g,
    Lanes<K, L>& s, int eb, int d1n, Shared<K>& sh, int warp, int w,
    int lane, Track<typename K::Cell>& row, Track<typename K::Cell>& col) {
  using Cell = typename K::Cell;
  // the halo: the right neighbour's first H and E (D1 = 1) or the left
  // neighbour's last H and F (D1 = 0), and its base; across a warp edge
  // the neighbour warp's published slot and the prefetched base
  Cell halo, xhalo;
  int bh;
  if (D1) {
    halo = K::from_right(s.H1[0]);
    xhalo = K::from_right(s.E1[0]);
    bh = __shfl_down_sync(kFull, s.b1[0], 1);
    if (lane == 31) {
      bh = eb;
      if (w + 1 < a.nw) {
        const Edge<Cell>& e = sh.first[(g.dd - 1) & 1][warp + 1];
        halo = e.h;
        xhalo = e.x;
      } else {
        halo = K::neg(g.dd - 1);
        xhalo = K::neg(g.dd - 1);
      }
    }
  } else {
    halo = K::from_left(s.H1[L - 1]);
    xhalo = K::from_left(s.F1[L - 1]);
    bh = __shfl_up_sync(kFull, s.b2[L - 1], 1);
    if (lane == 0) {
      bh = eb;
      if (w > 0) {
        const Edge<Cell>& e = sh.last[(g.dd - 1) & 1][warp - 1];
        halo = e.h;
        xhalo = e.x;
      } else {
        halo = K::neg(g.dd - 1);
        xhalo = K::neg(g.dd - 1);
      }
    }
  }
  const int x0 = g.bs + p.tp * L;   // row i of the thread's first lane
  const int t = x0 - g.v_lo;
  Cell Hn[L], En[L], Fn[L];
  unsigned mv[L];
  int n1[L], n2[L];
  unsigned vm = 0;
  const int ctx = k.diag_ctx(g.dd);
#pragma unroll
  for (int q = 0; q < L; ++q) {
    n1[q] = D1 ? (q + 1 < L ? s.b1[q + 1 < L ? q + 1 : 0] : bh) : s.b1[q];
    n2[q] = D1 ? s.b2[q] : (q > 0 ? s.b2[q > 0 ? q - 1 : 0] : bh);
    const bool valid =
        static_cast<unsigned>(t + q) < static_cast<unsigned>(g.v_n);
    vm |= static_cast<unsigned>(valid) << q;
    k.cell(at(s.H1, q + D1, halo), at(s.E1, q + D1, xhalo),
           at(s.H1, q + D1 - 1, halo), at(s.F1, q + D1 - 1, xhalo),
           at(s.G, q + D1 - 1, s.gprev), n1[q] == n2[q], valid, ctx,
           Hn[q], En[q], Fn[q], mv[q]);
  }
  // boundary cells: row 0 is the first lane of thread 0 while base is 0,
  // row dd lies in one thread's lanes while dd is inside the window
  const bool top = x0 == g.top;
  const int lq = g.left - x0;
  if (top || static_cast<unsigned>(lq) < static_cast<unsigned>(L)) {
    const Cell bc = k.boundary(g.dd);
#pragma unroll
    for (int q = 0; q < L; ++q) {
      if ((top && q == 0) || lq == q) {
        Hn[q] = bc;
        vm |= 1u << q;
      }
    }
  }
  // the last-row cell (i == len1) and last-column cell (j == len2) of the
  // diagonal lie in one lane of the pair
  const int qr = p.len1 - x0;
  const int qc = g.dd - p.len2 - x0;
  if (static_cast<unsigned>(qr) < L && ((vm >> qr) & 1)) {
    Cell h = Hn[0];
#pragma unroll
    for (int q = 1; q < L; ++q) if (qr == q) h = Hn[q];
    row.offer(h, K::score(h), g.dd);
  }
  if (static_cast<unsigned>(qc) < L && ((vm >> qc) & 1)) {
    Cell h = Hn[0];
#pragma unroll
    for (int q = 1; q < L; ++q) if (qc == q) h = Hn[q];
    col.offer(h, K::score(h), g.dd);
  }
  // H of d-1 into d's frame; the left neighbour's last lane of it is the
  // halo (D1 = 0) or this thread's first lane (D1 = 1)
  const Cell gp = D1 ? s.H1[0] : halo;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    s.G[q] = D1 ? at(s.H1, q + 1, halo) : s.H1[q];
  }
  s.gprev = gp;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    s.H1[q] = Hn[q];
    s.E1[q] = En[q];
    s.F1[q] = Fn[q];
    s.b1[q] = n1[q];
    s.b2[q] = n2[q];
  }
  if constexpr (K::kMoves) k.template store_moves<L>(a, p, g.dd, p.tp * L, mv);
  if (a.nw > 1) publish<K, L>(a, sh, s, g.dd, warp, lane, d1n != 0, d1n == 0);
}

template <class K, int L>
__device__ __forceinline__ void sweep_registers(
    const K& k, const Launch& a, const Pair& p, Shared<K>& sh,
    Track<typename K::Cell>& row, Track<typename K::Cell>& col, int warp,
    int w, int lane) {
  Lanes<K, L> s;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    // diagonal 0: only cell (0, 0), score 0; diagonal -1: unreachable;
    // every column of diagonal 0's lanes is <= 0
    const int r = p.tp * L + q;
    s.H1[q] = r == 0 ? K::origin() : K::neg(0);
    s.E1[q] = K::neg(0);
    s.F1[q] = K::neg(0);
    s.G[q] = K::neg(-1);
    s.b1[q] = row_base(p, r);
    s.b2[q] = kNoCol;
  }
  s.gprev = K::neg(-1);
  if (a.nw > 1) {
    publish<K, L>(a, sh, s, 0, warp, lane, true, true);
  }
  pair_sync(p);

  const int D = p.tot;
  const int band = K::kFixed ? 0 : a.band;
  Band bd{};
  if (band > 0) bd.init(p, band, 1);
  Schedule sc;
  if constexpr (!K::kFixed) sc.init(a, D, lane);
  int bs = 0;                                // base[dd]; base[0] == 0
  const int d11 = K::kFixed ? 0 : sc.shifts(1) & 1;
  // fixed frame: the diagonals on which the warp's rows [r0, r0 + 32 L)
  // hold a cell of the pair, [r0, r0 + 32 L - 1 + len2] while r0 <= len1
  const int r0 = w * 32 * L;
  const int act_lo = r0 <= p.len1 ? r0 : D + 1;
  const int act_hi = r0 + 32 * L - 1 + p.len2;
  int eb = edge_base<L>(p, w, lane, 1, d11, d11);
  for (int dd = 1; dd <= D; ++dd) {
    if (!K::kFixed && dd > 1 && ((dd - 1) & 31) == 0) {
      sc.advance(a, D, (dd - 1) >> 5, lane);
    }
    const unsigned shift = K::kFixed ? 0u : sc.shifts(dd);
    const int d1 = shift & 1;
    const int d1n = shift >> 1;
    bs += d1;
    const int ebn = edge_base<L>(p, w, lane, dd + 1, bs + d1n, d1n);
    const Diag g = diag(p, bd, band, dd, bs);
    if constexpr (K::kFixed) {
      // a warp outside [act_lo, act_hi] computes no cell that reaches one
      // of the matrix (the recurrence flows to larger i and j only); its
      // state and halo stay as they were, which differs from the sweep's
      // only in E and F far below any score of the matrix
      if (dd >= act_lo && dd <= act_hi) {
        reg_step<K, L, 0>(k, a, p, g, s, eb, 0, sh, warp, w, lane, row, col);
      } else if (a.nw > 1) {
        publish<K, L>(a, sh, s, dd, warp, lane, false, true);
      }
    } else if (d1) {
      reg_step<K, L, 1>(k, a, p, g, s, eb, d1n, sh, warp, w, lane, row, col);
    } else {
      reg_step<K, L, 0>(k, a, p, g, s, eb, d1n, sh, warp, w, lane, row, col);
    }
    if (a.nw > 1) pair_sync(p);
    if (band > 0) bd.next(p);
    eb = ebn;
  }
}

// One diagonal of memory mode: lanes tp, tp + kMemThreads, ... of the
// window, predecessors read from the rotating buffers.
template <class K, int D1, int D2>
__device__ __forceinline__ void mem_step(
    const K& k, const Launch& a, const Pair& p, const Diag& g, int* st,
    Track<typename K::Cell>& row, Track<typename K::Cell>& col) {
  using Cell = typename K::Cell;
  const int W = a.W;
  const int dd = g.dd;
  const int stride = K::kFields * W;
  int* Hc = st + (dd % 3) * stride;
  const int* H1 = st + ((dd + 2) % 3) * stride;
  const int* H2 = st + ((dd + 1) % 3) * stride;
  int* Ec = st + (3 + (dd & 1)) * stride;
  const int* E1 = st + (3 + ((dd + 1) & 1)) * stride;
  int* Fc = st + (5 + (dd & 1)) * stride;
  const int* F1 = st + (5 + ((dd + 1) & 1)) * stride;
  const int ctx = k.diag_ctx(dd);
  for (int l = p.tp; l < W; l += p.nthreads) {
    const int i = g.bs + l;
    const bool boundary = i == g.top || i == g.left;
    const bool valid =
        static_cast<unsigned>(i - g.v_lo) < static_cast<unsigned>(g.v_n) ||
        boundary;
    Cell h, e, fc;
    unsigned mv;
    k.cell(K::load(H1, W, l + D1, dd - 1), K::load(E1, W, l + D1, dd - 1),
           K::load(H1, W, l + D1 - 1, dd - 1),
           K::load(F1, W, l + D1 - 1, dd - 1),
           K::load(H2, W, l + D2 - 1, dd - 2),
           row_base(p, i) == col_base(p, dd - i), valid, ctx, h, e, fc, mv);
    if (boundary) h = k.boundary(dd);
    K::store(Hc, W, l, h);
    K::store(Ec, W, l, e);
    K::store(Fc, W, l, fc);
    if constexpr (K::kMoves) k.template store_moves<1>(a, p, dd, l, &mv);
    if (valid && i == p.len1) row.offer(h, K::score(h), dd);
    if (valid && i == dd - p.len2) col.offer(h, K::score(h), dd);
  }
}

template <class K>
__device__ __forceinline__ void sweep_memory(
    const K& k, const Launch& a, const Pair& p, Track<typename K::Cell>& row,
    Track<typename K::Cell>& col) {
  const int W = a.W;
  const int stride = K::kFields * W;
  int* st = a.scratch + static_cast<size_t>(p.b) * kBuffers * stride;
  for (int l = p.tp; l < W; l += p.nthreads) {
    for (int buf = 0; buf < kBuffers; ++buf) {
      // H's buffer 2 holds diagonal -1 at the first step, the rest 0
      K::store(st + buf * stride, W, l,
               (buf == 0 && l == 0) ? K::origin()
                                    : K::neg(buf == 2 ? -1 : 0));
    }
  }
  pair_sync(p);
  const int D = p.len1 + p.len2;
  const int band = K::kFixed ? 0 : a.band;
  Band bd{};
  if (band > 0) bd.init(p, band, 1);
  int b2 = K::kFixed ? 0 : __ldg(a.base);
  int b1 = b2;
  for (int dd = 1; dd <= D; ++dd) {
    const int bs = K::kFixed ? 0 : __ldg(a.base + dd);
    const Diag g = diag(p, bd, band, dd, bs);
    if constexpr (K::kFixed) {
      mem_step<K, 0, 0>(k, a, p, g, st, row, col);
    } else {
      switch ((bs - b1) * 2 + (b1 - b2)) {
        case 0: mem_step<K, 0, 0>(k, a, p, g, st, row, col); break;
        case 1: mem_step<K, 0, 1>(k, a, p, g, st, row, col); break;
        case 2: mem_step<K, 1, 1>(k, a, p, g, st, row, col); break;
        default: mem_step<K, 1, 2>(k, a, p, g, st, row, col); break;
      }
    }
    pair_sync(p);
    if (band > 0) bd.next(p);
    b2 = b1;
    b1 = bs;
  }
}

// The kernel: pairs [blockIdx.x * pairs, +pairs), nw warps each (register
// mode, L lanes per thread) or kMemThreads threads (memory mode, L == 1).
template <class K, int L, bool kMem>
__global__ void __launch_bounds__(block_threads<K, L>())
    wavefront_kernel(const Launch a) {
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ Shared<K> sh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pib = warp / a.nw;
  const int w = warp - pib * a.nw;
  Pair p;
  p.b = blockIdx.x * a.pairs + pib;
  if (p.b >= a.B) return;
  const long long* pm = a.pm + static_cast<size_t>(p.b) * 8;
  p.len1 = static_cast<int>(pm[0]);
  p.len2 = static_cast<int>(pm[1]);
  p.gopen = static_cast<int>(pm[2]);
  p.k = static_cast<int>(pm[3]);
  p.mid = static_cast<int>(pm[4]);
  p.tot = p.len1 + p.len2;
  p.tp = w * 32 + lane;
  p.nthreads = a.nw * 32;
  p.bar = 1 + pib;
  p.s1 = a.pool + pm[5];
  p.s2 = a.pool + pm[6];
  uint8_t* seg = dyn + static_cast<size_t>(pib) * a.seg;
  if (p.tp < 2) sh.keys[pib][p.tp] = 0ull;
  // (the first pair_sync of the sweep orders the keys)

  const K k(a, p);
  Track<typename K::Cell> row, col;
  row.ok = false;
  col.ok = false;
  if constexpr (kMem) {
    sweep_memory<K>(k, a, p, row, col);
  } else {
    sweep_registers<K, L>(k, a, p, sh, row, col, warp, w, lane);
  }
  pair_sync(p);
  if (row.ok) atomicMax(&sh.keys[pib][0], row.key());
  if (col.ok) atomicMax(&sh.keys[pib][1], col.key());
  pair_sync(p);
  k.finish(a, p, sh.keys[pib][0], sh.keys[pib][1], row, col, w, lane, seg);
}

template <class K, int L0, int... Ls>
bool launch_lanes(int lanes, int grid, int threads, size_t smem,
                  cudaStream_t stream, const Launch& a) {
  if (lanes == L0) {
    if (threads > block_threads<K, L0>()) return false;
    wavefront_kernel<K, L0, false><<<grid, threads, smem, stream>>>(a);
    return true;
  }
  if constexpr (sizeof...(Ls) > 0) {
    return launch_lanes<K, Ls...>(lanes, grid, threads, smem, stream, a);
  } else {
    return false;
  }
}

// Checks the geometry and launches the instantiation for (lanes, memory)
// on `stream`: pairs * nw * 32 threads per block, `extra` bytes of dynamic
// shared memory per pair for K.  Returns a cudaError_t value.
template <class K, int... Lanes>
int launch(Launch a, int lanes, int memory, int extra, cudaStream_t stream) {
  if (a.B <= 0) return 0;
  const int threads = a.pairs * a.nw * 32;
  const bool ok =
      a.W > 0 && a.nw >= 1 && a.pairs >= 1 && a.pairs <= kMaxPairs &&
      threads <= kMaxBlockThreads && (a.nw == 1 || a.pairs <= 15) &&
      (memory ? (a.pairs == 1 && a.nw * 32 == kMemThreads && a.scratch)
              : a.W == a.nw * 32 * lanes);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.seg = extra;
  const int grid = (a.B + a.pairs - 1) / a.pairs;
  const size_t smem = static_cast<size_t>(a.pairs) * a.seg;
  if (memory) {
    wavefront_kernel<K, 1, true><<<grid, threads, smem, stream>>>(a);
  } else if (!launch_lanes<K, Lanes...>(lanes, grid, threads, smem, stream,
                                        a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wf
