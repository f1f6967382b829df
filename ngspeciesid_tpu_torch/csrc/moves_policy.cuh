// The moves policy of wavefront.cuh, shared by moves_kernel.cu (a banded
// window that the host schedules) and full_dp_kernel.cu (the fixed full
// frame): the Gotoh cell on scores with its packed move byte, the move
// store, the endpoint rows and the warp-batched traceback.
//
//   * The cell: H, E, F one int each.  E and F are not masked: they run
//     free across the window, as on the TPU.  The move byte holds the H
//     layer in bits 0-1 (DIAG 1, UP 2, LEFT 3; the traceback's tie-break
//     diag > up > left), bit 2 "E opens here" and bit 3 "F opens here" (a
//     gap opens on >=).
//   * The move store is (B, D+1, W) uint8 in device memory: per diagonal a
//     thread writes its L move bytes as one L-byte store, for every lane of
//     the window (not only in-band cells), because the traceback can follow
//     an E/F chain across the band's edge.
//   * Traceback by the pair's first warp, in batches.  One step back moves
//     the path's lane by at most one per diagonal, so the 32 diagonals
//     below the current one lie within +-31 lanes of the current lane: the
//     warp loads that 32 x 68-byte block of the store into shared memory
//     (one row per lane, 17 word loads in flight; zero outside the window,
//     which no move byte is) and the window's shifts of those diagonals as
//     one ballot, then one thread walks traceback_moves' automaton through
//     it (state H, E or F; one op per anti-diagonal), tracking the path's
//     lane from the shifts, with one shared-memory load per step, until the
//     path leaves the block; the warp loads the next.  The walk starts at
//     the endpoint (the row when its score is >= the column's) and stops at
//     i == 0 or j == 0, or where the predecessor's lane leaves its
//     diagonal's window (a zero byte); with no endpoint above NEG it writes
//     nothing.
//   * MovesK<true> is the fixed frame (base 0 on every diagonal, band 0):
//     the path's lane is its row i, no shift is read, and every cell of the
//     matrix lies in the window, so the walk only stops at i == 0 or j == 0.

#pragma once

#include "wavefront.cuh"

namespace wf_moves {

using wf::kNeg;

constexpr uint8_t kDiag = 1, kUp = 2, kLeft = 3;
constexpr int kRows = 32;    // diagonals per traceback batch, one per lane
constexpr int kWords = 17;   // 4-byte words per batch row: 68 lanes
constexpr int kStride = kWords * 4;
constexpr int kTraceBytes = kRows * kStride;

template <bool kFixedFrame>
struct MovesK {
  using Cell = int;
  static constexpr int kFields = 1;
  static constexpr bool kMoves = true;
  static constexpr bool kFixed = kFixedFrame;

  int gopen, gap_ext, match, mismatch;

  __device__ MovesK(const wf::Launch& a, const wf::Pair& p)
      : gopen(p.gopen), gap_ext(a.gap_ext), match(a.match),
        mismatch(a.mismatch) {}

  __device__ static Cell neg(int) { return kNeg; }
  __device__ static Cell origin() { return 0; }
  __device__ static int score(const Cell& c) { return c; }
  __device__ static Cell from_right(const Cell& c) {
    return __shfl_down_sync(wf::kFull, c, 1);
  }
  __device__ static Cell from_left(const Cell& c) {
    return __shfl_up_sync(wf::kFull, c, 1);
  }
  __device__ static Cell load(const int* buf, int W, int l, int) {
    return (l < 0 || l >= W) ? kNeg : buf[l];
  }
  __device__ static void store(int* buf, int, int l, const Cell& c) {
    buf[l] = c;
  }

  __device__ int diag_ctx(int) const { return 0; }

  __device__ void cell(const Cell& hl, const Cell& el, const Cell& hu,
                       const Cell& fu, const Cell& g2, bool ismatch,
                       bool valid, int, Cell& h, Cell& e, Cell& f,
                       unsigned& mv) const {
    const int e_open = hl - gopen;
    const int e_ext = el - gap_ext;
    e = max(e_open, e_ext);
    const int f_open = hu - gopen;
    const int f_ext = fu - gap_ext;
    f = max(f_open, f_ext);
    const int g = g2 + (ismatch ? match : mismatch);
    // H: the traceback's tie-break, diag > up > left
    const int h_no_e = max(g, f);
    const unsigned layer = e > h_no_e ? kLeft : (f > g ? kUp : kDiag);
    h = valid ? max(h_no_e, e) : kNeg;
    mv = layer | (static_cast<unsigned>(e_open >= e_ext) << 2) |
         (static_cast<unsigned>(f_open >= f_ext) << 3);
  }

  __device__ static Cell boundary(int) { return 0; }

  // the move bytes of lanes [lane0, lane0 + L) of diagonal dd, one store
  // of L bytes
  template <int L>
  __device__ void store_moves(const wf::Launch& a, const wf::Pair& p, int dd,
                              int lane0, const unsigned* mv) const {
    uint8_t* row = a.store +
                   (static_cast<size_t>(p.b) * (a.dmax + 1) + dd) * a.W +
                   lane0;
    if constexpr (L == 1) {
      *row = static_cast<uint8_t>(mv[0]);
    } else if constexpr (L == 2) {
      *reinterpret_cast<uint16_t*>(row) =
          static_cast<uint16_t>(mv[0] | (mv[1] << 8));
    } else {
      unsigned w[L / 4];
#pragma unroll
      for (int x = 0; x < L / 4; ++x) {
        w[x] = mv[4 * x] | (mv[4 * x + 1] << 8) | (mv[4 * x + 2] << 16) |
               (mv[4 * x + 3] << 24);
      }
      if constexpr (L == 4) {
        *reinterpret_cast<unsigned*>(row) = w[0];
      } else {
        *reinterpret_cast<uint2*>(row) = make_uint2(w[0], w[1]);
      }
    }
  }

  __device__ void finish(const wf::Launch& a, const wf::Pair& p,
                         unsigned long long krow, unsigned long long kcol,
                         const wf::Track<Cell>&, const wf::Track<Cell>&,
                         int w, int lane, uint8_t* seg) const {
    // trackers [score, coord, diagonal]: (NEG, -1, -1) without a candidate
    const int rs = krow ? wf::key_score(krow) : kNeg;
    const int rd = krow ? wf::key_diag(krow) : -1;
    const int rj = krow ? rd - p.len1 : -1;
    const int cs = kcol ? wf::key_score(kcol) : kNeg;
    const int cd = kcol ? wf::key_diag(kcol) : -1;
    const int ci = kcol ? cd - p.len2 : -1;
    if (p.tp < 16) {
      const int c = p.tp;
      a.out[static_cast<size_t>(p.b) * 16 + c] =
          c == 0 ? rs : c == 1 ? rj : c == 2 ? rd
          : c == 8 ? cs : c == 9 ? ci : c == 10 ? cd : 0;
    }
    if (w != 0 || !a.trace) return;
    const bool use_row = rs >= cs;
    if ((use_row ? rs : cs) <= kNeg) return;
    traceback(a, p, lane, use_row ? p.len1 : ci, use_row ? rj : p.len2,
              seg);
  }

  // Whether the window moves down one lane at diagonal d >= 1 (never in
  // the fixed frame, which reads no schedule).
  __device__ __forceinline__ static bool shifts_at(const wf::Launch& a,
                                                   int d) {
    if constexpr (kFixedFrame) {
      return false;
    } else {
      return d >= 1 && __ldg(a.base + d) != __ldg(a.base + d - 1);
    }
  }

  // The automaton of ops/align.py::traceback_moves, one op per
  // anti-diagonal (state 0 H, 1 E, 2 F), run by the pair's first warp.
  // Batch: lane r loads row d0 - r of the store, the 68 lanes from the
  // aligned word at or below l - 32 (l the path's lane on d0), as 17 word
  // loads in flight together, and the shifts base[d] - base[d-1] of
  // diagonals d0 - r and d0 - r - 32; lane 0 then walks up to 32 diagonals
  // through the block.  A step to diagonal e - 1 or e - 2 moves the lane by
  // the shifts of the diagonals it leaves, minus one if the row drops.
  __device__ __forceinline__ static void traceback(const wf::Launch& a,
                                                   const wf::Pair& p,
                                                   int lane, int i, int j,
                                                   uint8_t* seg) {
    uint8_t* blk = seg;   // [kRows][kStride]
    const int W = a.W;
    const uint8_t* mv = a.store + static_cast<size_t>(p.b) * (a.dmax + 1) * W;
    uint8_t* out = a.ops + static_cast<size_t>(p.b) * a.dpad;
    if (i < 1 || j < 1) return;
    // the path's lane on its diagonal
    int l = kFixedFrame ? i : i - __ldg(a.base + i + j);
    int state = 0;
    while (true) {
      const int d0 = i + j;
      // the block's first lane: word-aligned (W is a multiple of 4, so a
      // word lies wholly inside or outside the window)
      const int a0 = (l - 32) & ~3;
      const int dd = d0 - lane;
      unsigned words[kWords];
#pragma unroll
      for (int x = 0; x < kWords; ++x) {
        const int c = a0 + 4 * x;
        words[x] = (dd >= 0 && c >= 0 && c < W)
                       ? *reinterpret_cast<const unsigned*>(
                             mv + static_cast<size_t>(dd) * W + c)
                       : 0u;
      }
      const bool s1 = shifts_at(a, dd);
      const bool s2 = shifts_at(a, dd - 32);
      unsigned* row = reinterpret_cast<unsigned*>(blk + lane * kStride);
#pragma unroll
      for (int x = 0; x < kWords; ++x) row[x] = words[x];
      unsigned long long bits = 0;
      if constexpr (!kFixedFrame) {
        bits = (static_cast<unsigned long long>(__ballot_sync(wf::kFull, s2))
                << 32) | __ballot_sync(wf::kFull, s1);
      }
      __syncwarp();
      int stop = 0;
      if (lane == 0) {
        while (true) {
          const int e = i + j;
          const int r = d0 - e;
          if (r >= kRows) break;
          if (i < 1 || j < 1) {
            stop = 1;
            break;
          }
          // |l - (first l)| <= r <= 31 and first l - 35 <= a0 <= first
          // l - 32, so the byte lies inside the block's row
          const uint8_t m = blk[r * kStride + (l - a0)];
          if (m == 0) {   // outside the diagonal's window
            stop = 1;
            break;
          }
          const int sh = static_cast<int>(bits >> r) & 1;
          if (state == 0) {
            const int layer = m & 3;
            if (layer == kDiag) {
              out[e] = kDiag;
              --i;
              --j;
              l += sh + (static_cast<int>(bits >> (r + 1)) & 1) - 1;
              continue;
            }
            state = layer == kLeft ? 1 : 2;
          }
          if (state == 1) {
            out[e] = kLeft;
            --j;
            l += sh;
            if (m & 4) state = 0;
          } else {
            out[e] = kUp;
            --i;
            l += sh - 1;
            if (m & 8) state = 0;
          }
        }
      }
      i = __shfl_sync(wf::kFull, i, 0);
      j = __shfl_sync(wf::kFull, j, 0);
      l = __shfl_sync(wf::kFull, l, 0);
      state = __shfl_sync(wf::kFull, state, 0);
      stop = __shfl_sync(wf::kFull, stop, 0);
      __syncwarp();
      if (stop) break;
    }
  }
};

}  // namespace wf_moves
