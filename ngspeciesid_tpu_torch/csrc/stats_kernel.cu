// Banded semi-global Gotoh DP that carries alignment-path statistics forward.
//
// Replaces the TPU kernel ngspeciesid_tpu/ops/align_stats_pallas.py
// (_stats_kernel, launched by _pallas_stats) with the same int32 semantics:
// for each pair it returns the 16 int32 of the last-row and last-column
// endpoint trackers [score, coord, hist, wsum, wcount, mcount, colcount,
// diagonal] that ops/align_stats.py::_gather_chunk turns into the
// aligned-region ratios and the column identity.
//
// What bounds it on an H100: not memory and not FLOPs.  A pair is a chain of
// len1 + len2 anti-diagonals, each depending on the two before it, so the
// kernel is latency-bound: one __syncthreads per diagonal, a few dozen
// integer ALU operations per cell, and a few bytes of state traffic per cell
// (5 int32 fields x 3 layers, read from shared memory, written once).
// Nothing is reused across pairs, so there is nothing for tensor cores, TMA
// or L2 blocking to do.
//
// Design:
//   * One thread block per pair, threads over the W lanes of the pair's
//     window (strided loop when W > blockDim).  Many pairs per launch (up to
//     4096) keep every SM busy while each block walks its own diagonals:
//     this replaces the TPU grid's sequential diagonal axis, and a block
//     stops at its own pair's last diagonal (the TPU's tile skip).
//   * Lane l of diagonal d holds cell (i, j) = (base[d] + l, d - i); base is
//     the host window schedule shared by the chunk.  The TPU's lane rolls
//     (_shift_lanes) become address arithmetic: the predecessor of row i on
//     diagonal d-1 sits at lane l + (base[d] - base[d-1]).  A predecessor
//     outside the previous window reads (NEG_INF, 0, 0, 0, 0), as on the TPU.
//   * State lives in rotating per-diagonal buffers (H for d, d-1, d-2; E and
//     F for d, d-1), in dynamic shared memory when 140*W bytes fit the
//     device, else in a global scratch slab the wrapper allocates (band 0 on
//     long reads; ngsid_stats_scratch_ints says which).
//   * wsum is not stored: it always equals popcount(hist) (both start at 0,
//     and every push shifts one bit out of and one bit into the k-bit
//     window), so five fields carry the six of the TPU kernel.
//   * The last-row (last-column) cell of a diagonal lies in exactly one lane,
//     so that lane's thread updates a block-level tracker in shared memory
//     with ">=" (the later diagonal wins ties); no cross-lane reduction.
//     The final pick (max score, then max diagonal) falls out of the order.
//   * Scores stay int32 and E/F are not clamped, as in the TPU's int32 path.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (ops/cuda_lib.py), loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);   // ops/align.py NEG_INF
constexpr int kFields = 5;         // score, hist, wcount, mcount, colcount
constexpr int kBuffers = 7;        // H x3, E x2, F x2
constexpr int kMaxThreads = 512;
constexpr int kTrackerBytes = 16 * sizeof(int);  // static shared trk[16]

struct Cell {
  int s, h, wc, mc, cc;
};

// Field f of lane l of a buffer sits at buf[f * W + l].
__device__ __forceinline__ Cell load_cell(const int* buf, int W, int lane) {
  if (lane < 0 || lane >= W) return Cell{kNeg, 0, 0, 0, 0};
  return Cell{buf[lane], buf[W + lane], buf[2 * W + lane], buf[3 * W + lane],
              buf[4 * W + lane]};
}

__device__ __forceinline__ void store_cell(int* buf, int W, int lane,
                                           const Cell& c) {
  buf[lane] = c.s;
  buf[W + lane] = c.h;
  buf[2 * W + lane] = c.wc;
  buf[3 * W + lane] = c.mc;
  buf[4 * W + lane] = c.cc;
}

// One alignment column with match bit `bit` (_push_column): shift the k-bit
// match history, count the window if it holds >= mid matches.
__device__ __forceinline__ Cell push(Cell c, int bit, int k, int mid,
                                     unsigned mask) {
  const unsigned h2 = ((static_cast<unsigned>(c.h) << 1) | bit) & mask;
  c.h = static_cast<int>(h2);
  c.cc += 1;
  c.wc += (c.cc >= k && __popc(h2) >= mid) ? 1 : 0;
  c.mc += bit;
  return c;
}

// Tracker payload: [score, coord, hist, wsum, wcount, mcount, colcount, d].
__device__ __forceinline__ void track(int* trk, const Cell& c, int coord,
                                      int dd) {
  if (c.s >= trk[0]) {
    trk[0] = c.s;
    trk[1] = coord;
    trk[2] = c.h;
    trk[3] = __popc(static_cast<unsigned>(c.h));
    trk[4] = c.wc;
    trk[5] = c.mc;
    trk[6] = c.cc;
    trk[7] = dd;
  }
}

// pm: (B, 8) int64 rows [len1, len2, gap_open, k, match_id, off1, off2, 0];
// base: window origin per diagonal; out: (B, 16) int32.
__global__ void stats_kernel(const uint8_t* __restrict__ pool,
                             const long long* __restrict__ pm,
                             const int* __restrict__ base,
                             int* __restrict__ out, int* scratch, int W,
                             int band, int match, int mismatch, int gap_ext) {
  extern __shared__ int smem[];
  __shared__ int trk[kTrackerBytes / sizeof(int)];  // row [0, 8), column [8, 16)

  const int b = blockIdx.x;
  const int stride = kFields * W;
  int* st = scratch ? scratch + static_cast<size_t>(b) * kBuffers * stride
                    : smem;
  const long long* p = pm + static_cast<size_t>(b) * 8;
  const int len1 = static_cast<int>(p[0]);
  const int len2 = static_cast<int>(p[1]);
  const int gopen = static_cast<int>(p[2]);
  const int k = static_cast<int>(p[3]);
  const int mid = static_cast<int>(p[4]);
  const uint8_t* s1 = pool + p[5];
  const uint8_t* s2 = pool + p[6];
  const unsigned mask = (1u << k) - 1u;
  const int wc_boundary_on = mid <= 0;

  // diagonal 0 in H slot 0 (only cell (0, 0), score 0), diagonal -1 in
  // H slot 2, and E/F of diagonal 0 in slot 0: all unreachable otherwise
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    for (int buf = 0; buf < kBuffers; ++buf) {
      store_cell(st + buf * stride, W, l,
                 Cell{(buf == 0 && l == 0) ? 0 : kNeg, 0, 0, 0, 0});
    }
  }
  if (threadIdx.x < 16) {
    const int f = threadIdx.x & 7;
    trk[threadIdx.x] = f == 0 ? kNeg : (f == 1 ? -1 : 0);
  }
  __syncthreads();

  const int D = len1 + len2;
  for (int dd = 1; dd <= D; ++dd) {
    const int bs = base[dd];
    const int d1 = bs - base[dd - 1];
    const int d2 = bs - base[dd >= 2 ? dd - 2 : 0];
    int* Hc = st + (dd % 3) * stride;
    const int* H1 = st + ((dd + 2) % 3) * stride;
    const int* H2 = st + ((dd + 1) % 3) * stride;
    int* Ec = st + (3 + (dd & 1)) * stride;
    const int* E1 = st + (3 + ((dd + 1) & 1)) * stride;
    int* Fc = st + (5 + (dd & 1)) * stride;
    const int* F1 = st + (5 + ((dd + 1) & 1)) * stride;

    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int i = bs + l;
      const int j = dd - i;
      const bool in1 = i >= 1 && i <= len1;
      const bool in2 = j >= 1 && j <= len2;
      bool interior = in1 && in2;
      if (band > 0) {
        interior = interior && (j - band) * len1 <= i * len2 &&
                   i * len2 <= (j + band + 1) * len1 - 1;
      }
      const bool boundary =
          (i == 0 && j >= 0 && j <= len2) || (j == 0 && i <= len1);
      const bool valid = interior || boundary;

      // E: gap in s1 (left), predecessor (i, j-1) on diagonal d-1
      const Cell hl = load_cell(H1, W, l + d1);
      const Cell el = load_cell(E1, W, l + d1);
      const int e_open = hl.s - gopen;
      const int e_ext = el.s - gap_ext;
      Cell e = e_open >= e_ext ? hl : el;
      e.s = max(e_open, e_ext);
      e = push(e, 0, k, mid, mask);

      // F: gap in s2 (up), predecessor (i-1, j) on diagonal d-1
      const Cell hu = load_cell(H1, W, l + d1 - 1);
      const Cell fu = load_cell(F1, W, l + d1 - 1);
      const int f_open = hu.s - gopen;
      const int f_ext = fu.s - gap_ext;
      Cell f = f_open >= f_ext ? hu : fu;
      f.s = max(f_open, f_ext);
      f = push(f, 0, k, mid, mask);

      // diagonal: (i-1, j-1) on diagonal d-2 plus the substitution column
      const int ismatch = (in1 && in2 && s1[i - 1] == s2[j - 1]) ? 1 : 0;
      Cell g = load_cell(H2, W, l + d2 - 1);
      g.s += mismatch + ismatch * (match - mismatch);
      g = push(g, ismatch, k, mid, mask);

      // H: the traceback's tie-break, diag > up > left
      const int h_no_e = max(g.s, f.s);
      Cell h = e.s > h_no_e ? e : (f.s > g.s ? f : g);
      if (boundary) {
        // a boundary cell restarts the path: i + j = dd leading gap columns
        h = Cell{0, 0, wc_boundary_on ? max(dd - k + 1, 0) : 0, 0, dd};
      }
      if (!valid) h.s = kNeg;

      store_cell(Hc, W, l, h);
      store_cell(Ec, W, l, e);
      store_cell(Fc, W, l, f);
      if (valid && i == len1) track(trk, h, j, dd);
      if (valid && j == len2) track(trk + 8, h, i, dd);
    }
    __syncthreads();
  }
  if (threadIdx.x < 16) out[static_cast<size_t>(b) * 16 + threadIdx.x] =
      trk[threadIdx.x];
}

}  // namespace

extern "C" {

// Sets *ints to 0 when one block's DP state at window width W fits in the
// shared memory of `device`, else to the int32 count of global scratch each
// block needs.  Returns the CUDA error code of the device query.
int ngsid_stats_scratch_ints(int W, int device, int* ints) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long state = static_cast<long long>(kBuffers) * kFields * W;
  const long long bytes =
      state * static_cast<long long>(sizeof(int)) + kTrackerBytes;
  *ints = bytes <= limit ? 0 : static_cast<int>(state);
  return 0;
}

// Launches one block per pair on `stream`.  With scratch == nullptr the DP
// state lives in dynamic shared memory; otherwise `scratch` holds B blocks
// of ngsid_stats_scratch_ints(W) int32.  Returns cudaGetLastError() after
// the launch.
int ngsid_stats_launch(const void* pool, const void* pm, const void* base,
                       void* out, void* scratch, int B, int W, int band,
                       int match, int mismatch, int gap_ext, void* stream) {
  if (B <= 0) return 0;
  const int smem_bytes =
      scratch ? 0 : static_cast<int>(kBuffers * kFields * W * sizeof(int));
  if (smem_bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = W < kMaxThreads ? W : kMaxThreads;
  stats_kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const long long*>(pm),
      static_cast<const int*>(base), static_cast<int*>(out),
      static_cast<int*>(scratch), W, band, match, mismatch, gap_ext);
  return static_cast<int>(cudaGetLastError());
}

const char* ngsid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
