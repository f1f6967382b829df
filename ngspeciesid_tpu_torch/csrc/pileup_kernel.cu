// The polish pileup on the card: per-column votes, quality-weighted votes,
// coverage and insertion events of reads aligned against a fixed center,
// read from the moves kernel's traced paths where they lie.
//
// Replaces no TPU kernel: the JAX package accumulates the pileup on the
// host, in its C++ engine (native/sgdp.cpp, sg_pileup_native) or in Python
// (ops/poa.py::_walk).  It was added so that the moves kernel's op streams
// (csrc/moves_kernel.cu: one op per anti-diagonal, the endpoint rows in
// `best`) are consumed on the card, and only the column counts (about
// 60 KB for a 700 bp center) and the insertion events (about 15 a read)
// cross to the host.  ops/pileup.py launches it; its plain PyTorch version
// there (walk_rows_plain, reduce_rows_plain) is the same function.
//
// What bounds it on an H100: bytes, and few of them: each pair's op stream
// in, its read bases and qualities, the column counts out.  At the plate's
// polish shape that is about 1 MB a call, well under a microsecond of
// HBM time; launches and the latency of a serial walk over each path set
// its time.
//
// Design.
//   walk_kernel: one warp per pair of a launched moves chunk, 32 consecutive
//     anti-diagonals per step.  Pass 1 counts the path's ops by ballots and
//     finds its first and last DIAG (ops/align_moves.py::_reconstruct's
//     endpoint, ops/poa.py::trim_to_aligned's head and tail rule, with no
//     move array built).  Pass 2 walks the core: popc prefix sums of the
//     ballots give each op its center column and read index; a DIAG writes
//     its base's symbol (A C G T, or "no vote" for any other byte) and
//     weight 1 - PHRED_TO_P_CAPPED[q] into the read's row of a (reads x L)
//     matrix, an UP writes a gap; insertion runs (maximal LEFT stretches)
//     are written as (pos, r_lo, r_hi) into the read's slice of an event
//     buffer, in the walk's order: the head terminal extension, the
//     internal runs left to right, the tail terminal extension.  The read's
//     span [lo, hi] gives its coverage; inside [lo, hi) every column holds
//     one symbol of it, so nothing is cleared beforehand.
//   reduce_kernel: one thread per center column (and the slot L) adds the
//     reads' votes in read order, the addition order of the host walk, so
//     the float64 sums are the same bits; no atomics.  One extra warp packs
//     every read's events, in read order, into (pos, read, r_lo, r_hi)
//     rows and writes their count after the column counts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (ops/cuda_lib.py), loaded with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ops/align.py's move codes; ops/poa.py's symbol columns
constexpr int kDiag = 1, kUp = 2, kLeft = 3;
constexpr int kGap = 4, kNoVote = 5;
// ops/align_moves.py::_reconstruct: an endpoint score at or below
// NEG_INF // 2 (NEG_INF = -2**30) is unreachable
constexpr int kUnreachable = -(1 << 29);
// pairs (warps) per block of the walk; threads per block of the reduction
constexpr int kWalkWarps = 4;
constexpr int kReduceThreads = 128;

struct WalkArgs {
  const uint8_t* ops;      // (B, dpad) op streams of the chunk
  const int* best;         // (B, 16) endpoint rows
  const long long* pm;     // (B, 8) pair table: len1, len2, .., off2 at 6
  const uint8_t* pool;     // the call's sequences
  const long long* idx;    // (B,) read index of each pair
  const long long* rinfo;  // (R, 2) window start and quality offset a read
  const uint8_t* quals;    // the reads' qualities, concatenated
  const double* wtab;      // PHRED_TO_P_CAPPED, 128 float64
  uint8_t* sym;            // (R, L) symbol of each read at each column
  double* wt;              // (R, L) its weight (bases only)
  int* spans;              // (R, 2) coverage span [lo, hi]; (0, -1): none
  int* ev;                 // (R, cap, 3) events (pos, r_lo, r_hi)
  int* nev;                // (R,) events of each read
  int B, dpad, L, cap, has_quals;
};

struct ReduceArgs {
  const uint8_t* sym;
  const double* wt;
  const int* spans;
  const int* ev;
  const int* nev;
  double* stats;  // votes (L, 5), qvotes (L, 5), coverage (L + 1), count
  int* evout;     // (events, 4): pos, read, r_lo, r_hi
  int R, L, cap;
};

__device__ __forceinline__ int base_symbol(uint8_t b) {
  return b == 'A' ? 0 : b == 'C' ? 1 : b == 'G' ? 2 : b == 'T' ? 3 : kNoVote;
}

__global__ void __launch_bounds__(kWalkWarps * 32) walk_kernel(WalkArgs a) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWalkWarps + (threadIdx.x >> 5);
  if (b >= a.B) return;  // the whole warp
  const unsigned all = 0xffffffffu;
  const unsigned lt = (1u << lane) - 1u;
  const long long* pm = a.pm + 8LL * b;
  const int n = static_cast<int>(pm[0]), m = static_cast<int>(pm[1]);
  const uint8_t* read = a.pool + pm[6];
  const uint8_t* row = a.ops + static_cast<long long>(b) * a.dpad;
  const int* best = a.best + 16LL * b;
  const int r = static_cast<int>(a.idx[b]);
  const int wl = static_cast<int>(a.rinfo[2LL * r]);
  const uint8_t* q = a.quals + a.rinfo[2LL * r + 1];
  int* ev = a.ev + 3LL * a.cap * r;
  uint8_t* sym = a.sym + static_cast<long long>(r) * a.L + wl;
  double* wt = a.wt + static_cast<long long>(r) * a.L + wl;
  int lo = 0, hi = -1, nev = 0;
  if (best[0] > kUnreachable || best[8] > kUnreachable) {
    const bool use_row = best[0] >= best[8];
    const int end_i = use_row ? n : best[9];
    const int end_j = use_row ? best[1] : m;
    const int dend = end_i + end_j;  // the path's last anti-diagonal
    // pass 1: the path's op counts, its first and last DIAG, and the UPs
    // and LEFTs before the first DIAG (trim_to_aligned's head)
    int nd = 0, nu = 0, nl = 0, d0 = -1, d1 = -1, up0 = 0, left0 = 0;
    for (int t = 0; t <= dend; t += 32) {
      const int d = t + lane;
      const int op = d <= dend ? row[d] : 0;
      const unsigned bd = __ballot_sync(all, op == kDiag);
      const unsigned bu = __ballot_sync(all, op == kUp);
      const unsigned bl = __ballot_sync(all, op == kLeft);
      if (bd) {
        if (d0 < 0) {
          const int f = __ffs(bd) - 1;
          const unsigned below = (1u << f) - 1u;
          d0 = t + f;
          up0 = nu + __popc(bu & below);
          left0 = nl + __popc(bl & below);
        }
        d1 = t + 31 - __clz(bd);
      }
      nd += __popc(bd);
      nu += __popc(bu);
      nl += __popc(bl);
    }
    if (nd > 0) {
      // the core's first column and read base: _reconstruct's terminal
      // gaps (end - ops) plus the head's UPs and LEFTs
      const int ci0 = end_i - nd - nu + up0;
      const int ri0 = end_j - nd - nl + left0;
      const int head = wl == 0 && ci0 == 0 && ri0 > 0;
      int commits = 0, bases = 0, runs = 0;
      // pass 2: the core, d0..d1; a LEFT is never at either end, so
      // row[d - 1] and row[d + 1] lie inside it
      for (int t = d0; t <= d1; t += 32) {
        const int d = t + lane;
        const int op = d <= d1 ? row[d] : 0;
        const bool left = op == kLeft;
        const bool opens = left && row[d - 1] != kLeft;
        const bool closes = left && row[d + 1] != kLeft;
        const unsigned bc = __ballot_sync(all, op == kDiag || op == kUp);
        const unsigned br = __ballot_sync(all, op == kDiag || left);
        const unsigned bs = __ballot_sync(all, opens);
        const int ci = ci0 + commits + __popc(bc & lt);
        const int ri = ri0 + bases + __popc(br & lt);
        if (op == kDiag) {
          sym[ci] = static_cast<uint8_t>(base_symbol(read[ri]));
          wt[ci] = a.has_quals ? __dsub_rn(1.0, a.wtab[q[ri]]) : 1.0;
        } else if (op == kUp) {
          sym[ci] = kGap;
        }
        // a run's event: opened by its first LEFT (position: the column of
        // the next commit), closed by its last
        const int k = head + runs + __popc(bs & lt);
        if (opens) {
          ev[3 * k] = wl + ci;
          ev[3 * k + 1] = ri;
        }
        if (closes) ev[3 * (k + (opens ? 1 : 0)) - 1] = ri + 1;
        commits += __popc(bc);
        bases += __popc(br);
        runs += __popc(bs);
      }
      const int ci_end = ci0 + commits, r_done = ri0 + bases;
      const int tail = wl + n == a.L && ci_end == n && r_done < m;
      if (lane == 0) {
        if (head) {
          ev[0] = 0;
          ev[1] = 0;
          ev[2] = ri0;
        }
        if (tail) {
          int* e = ev + 3 * (head + runs);
          e[0] = a.L;
          e[1] = r_done;
          e[2] = m;
        }
      }
      nev = head + runs + tail;
      lo = wl + ci0;
      hi = wl + ci_end;
    }
  }
  if (lane == 0) {
    a.nev[r] = nev;
    a.spans[2 * r] = lo;
    a.spans[2 * r + 1] = hi;
  }
}

// one warp: every read's events, in read order, into evout; their count
// into the last slot of stats
__device__ void pack_events(const ReduceArgs& a) {
  const int lane = threadIdx.x & 31;
  int done = 0;
  for (int t = 0; t < a.R; t += 32) {
    const int r = t + lane;
    const int c = r < a.R ? a.nev[r] : 0;
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const int at = done + incl - c;
    for (int k = 0; k < c; ++k) {
      const int* e = a.ev + 3LL * (static_cast<long long>(a.cap) * r + k);
      int* o = a.evout + 4LL * (at + k);
      o[0] = e[0];
      o[1] = r;
      o[2] = e[1];
      o[3] = e[2];
    }
    done += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) a.stats[11LL * a.L + 1] = done;
}

__global__ void __launch_bounds__(kReduceThreads) reduce_kernel(ReduceArgs a) {
  const int columns = (a.L + kReduceThreads) / kReduceThreads;  // L + 1 slots
  if (static_cast<int>(blockIdx.x) == columns) {
    if (threadIdx.x < 32) pack_events(a);
    return;
  }
  const int p = blockIdx.x * kReduceThreads + threadIdx.x;
  if (p > a.L) return;
  double v0 = 0, v1 = 0, v2 = 0, v3 = 0, v4 = 0;
  double q0 = 0, q1 = 0, q2 = 0, q3 = 0, q4 = 0, cov = 0;
#pragma unroll 4
  for (int r = 0; r < a.R; ++r) {
    const int lo = a.spans[2 * r], hi = a.spans[2 * r + 1];
    if (p < lo || p > hi) continue;
    cov = __dadd_rn(cov, 1.0);
    if (p == hi) continue;
    const long long at = static_cast<long long>(r) * a.L + p;
    const int s = a.sym[at];
    if (s == kGap) {
      v4 = __dadd_rn(v4, 1.0);
      q4 = __dadd_rn(q4, 1.0);
    } else if (s < 4) {
      const double w = a.wt[at];
      if (s == 0) {
        v0 = __dadd_rn(v0, 1.0);
        q0 = __dadd_rn(q0, w);
      } else if (s == 1) {
        v1 = __dadd_rn(v1, 1.0);
        q1 = __dadd_rn(q1, w);
      } else if (s == 2) {
        v2 = __dadd_rn(v2, 1.0);
        q2 = __dadd_rn(q2, w);
      } else {
        v3 = __dadd_rn(v3, 1.0);
        q3 = __dadd_rn(q3, w);
      }
    }
  }
  if (p < a.L) {
    double* v = a.stats + 5LL * p;
    double* qv = a.stats + 5LL * a.L + 5LL * p;
    v[0] = v0, v[1] = v1, v[2] = v2, v[3] = v3, v[4] = v4;
    qv[0] = q0, qv[1] = q1, qv[2] = q2, qv[3] = q3, qv[4] = q4;
  }
  a.stats[10LL * a.L + p] = cov;
}

}  // namespace

extern "C" {

// Walks the B pairs of one launched moves chunk into the call's pileup
// matrices (ops/pileup.py::walk_rows) on `stream`: one warp a pair.
// Returns cudaGetLastError() after the launch.
int ngsid_pileup_walk_launch(const void* ops, const void* best, const void* pm,
                             const void* pool, const void* idx,
                             const void* rinfo, const void* quals,
                             const void* wtab, void* sym, void* wt,
                             void* spans, void* ev, void* nev, int B, int dpad,
                             int L, int cap, int has_quals, void* stream) {
  if (B <= 0) return cudaSuccess;
  WalkArgs a{};
  a.ops = static_cast<const uint8_t*>(ops);
  a.best = static_cast<const int*>(best);
  a.pm = static_cast<const long long*>(pm);
  a.pool = static_cast<const uint8_t*>(pool);
  a.idx = static_cast<const long long*>(idx);
  a.rinfo = static_cast<const long long*>(rinfo);
  a.quals = static_cast<const uint8_t*>(quals);
  a.wtab = static_cast<const double*>(wtab);
  a.sym = static_cast<uint8_t*>(sym);
  a.wt = static_cast<double*>(wt);
  a.spans = static_cast<int*>(spans);
  a.ev = static_cast<int*>(ev);
  a.nev = static_cast<int*>(nev);
  a.B = B;
  a.dpad = dpad;
  a.L = L;
  a.cap = cap;
  a.has_quals = has_quals;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  walk_kernel<<<(B + kWalkWarps - 1) / kWalkWarps, kWalkWarps * 32, 0, s>>>(a);
  return cudaGetLastError();
}

// Adds the walked reads of a call, in read order, into `stats` ((11 L + 2)
// float64) and packs their events into `evout` (ops/pileup.py::
// reduce_rows) on `stream`.  Returns cudaGetLastError() after the launch.
int ngsid_pileup_reduce_launch(const void* sym, const void* wt,
                               const void* spans, const void* ev,
                               const void* nev, void* stats, void* evout,
                               int R, int L, int cap, void* stream) {
  ReduceArgs a{};
  a.sym = static_cast<const uint8_t*>(sym);
  a.wt = static_cast<const double*>(wt);
  a.spans = static_cast<const int*>(spans);
  a.ev = static_cast<const int*>(ev);
  a.nev = static_cast<const int*>(nev);
  a.stats = static_cast<double*>(stats);
  a.evout = static_cast<int*>(evout);
  a.R = R;
  a.L = L;
  a.cap = cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (L + kReduceThreads) / kReduceThreads + 1;
  reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
