// Banded semi-global Gotoh DP with an on-device traceback: one op stream per
// pair.
//
// Replaces the TPU kernel ngspeciesid_tpu/ops/align_moves_pallas.py
// (_moves_kernel, launched by _pallas_moves) with the same int32 semantics:
// for each pair it writes the endpoint trackers into best (B, 16) int32 (row
// score, j, diagonal at columns 0-2; column score, i, diagonal at columns
// 8-10; zeros elsewhere) and one op per anti-diagonal of the optimal path
// into ops (B, Dpad) uint8 (DIAG 1, UP 2, LEFT 3; 0 elsewhere).
// ops/align_moves.py::_reconstruct adds the terminal gaps on the host.
//
// What bounds it on an H100: not FLOPs.  A pair is a chain of len1 + len2
// anti-diagonals, each depending on the two before it, so the forward sweep
// is latency-bound (one __syncthreads per diagonal, a dozen integer ALU
// operations per cell), and the traceback is a chain of dependent loads from
// the move store, which is written once and read back along one path.  The
// least time is set by bytes: one move byte per in-band cell must reach
// device memory, since the traceback runs after the sweep.
//
// Design:
//   * The forward sweep is the skeleton of stats_kernel.cu with scores only:
//     one thread block per pair, threads over the W lanes of the pair's
//     window, rotating per-diagonal buffers for H (3), E (2) and F (2) in
//     dynamic shared memory (a global scratch slab when 28*W bytes do not
//     fit; ngsid_moves_scratch_ints says which), and a block stops at its
//     own pair's last diagonal.  E and F are not masked: they run free
//     across the window, as on the TPU.  A predecessor outside the previous
//     window reads as NEG.
//   * The move store is (B, D+1, W) uint8 in device memory, allocated by
//     the wrapper: each diagonal writes its W bytes coalesced, for every
//     lane of the window (not only in-band cells), because the traceback
//     can follow an E/F chain across the band's edge.  This replaces the
//     TPU's VMEM store and its 12 MB cap: no chunk falls back.
//   * The last-row (last-column) cell of a diagonal lies in one lane, whose
//     thread updates a block tracker in shared memory with ">=" (the later
//     diagonal wins ties); no cross-lane reduction.
//   * The TPU extracts the path with a mask pass over lanes per diagonal.
//     Here, after a __syncthreads, thread 0 walks the path through the
//     store: the path crosses each anti-diagonal at most once, so the walk
//     writes the same stream.  It starts at the endpoint in state H
//     (the row when its score is >= the column's) and stops at i == 0 or
//     j == 0, or where the predecessor's lane leaves its diagonal's window
//     (where the TPU's lane shift fills 0); with no endpoint above NEG it
//     writes nothing.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (ops/cuda_lib.py), loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);   // ops/align.py NEG_INF
constexpr int kBuffers = 7;        // H x3, E x2, F x2
constexpr int kMaxThreads = 512;
constexpr int kTrackerBytes = 6 * sizeof(int);  // static shared trk[6]
constexpr uint8_t kDiag = 1, kUp = 2, kLeft = 3;

__device__ __forceinline__ int load(const int* buf, int W, int lane) {
  return (lane < 0 || lane >= W) ? kNeg : buf[lane];
}

// pm: (B, 8) int64 rows [len1, len2, gap_open, -, -, off1, off2, -];
// base: window origin per diagonal; store: (B, D+1, W) uint8;
// ops: (B, dpad) uint8, zeroed by the caller; best: (B, 16) int32.
__global__ void moves_kernel(const uint8_t* __restrict__ pool,
                             const long long* __restrict__ pm,
                             const int* __restrict__ base,
                             uint8_t* __restrict__ store,
                             uint8_t* __restrict__ ops,
                             int* __restrict__ best, int* scratch, int W,
                             int D, int dpad, int band, int match,
                             int mismatch, int gap_ext) {
  extern __shared__ int smem[];
  __shared__ int trk[kTrackerBytes / sizeof(int)];  // row s,j,d | col s,i,d

  const int b = blockIdx.x;
  int* st = scratch ? scratch + static_cast<size_t>(b) * kBuffers * W : smem;
  const long long* p = pm + static_cast<size_t>(b) * 8;
  const int len1 = static_cast<int>(p[0]);
  const int len2 = static_cast<int>(p[1]);
  const int gopen = static_cast<int>(p[2]);
  const uint8_t* s1 = pool + p[5];
  const uint8_t* s2 = pool + p[6];
  uint8_t* mv = store + static_cast<size_t>(b) * (D + 1) * W;

  // diagonal 0 in H slot 0 (only cell (0, 0), score 0), diagonal -1 in
  // H slot 2, and E/F of diagonal 0 in slot 0: all unreachable otherwise
  for (int l = threadIdx.x; l < W; l += blockDim.x) {
    for (int buf = 0; buf < kBuffers; ++buf) {
      st[buf * W + l] = (buf == 0 && l == 0) ? 0 : kNeg;
    }
  }
  if (threadIdx.x < 6) trk[threadIdx.x] = threadIdx.x % 3 == 0 ? kNeg : -1;
  __syncthreads();

  const int last = len1 + len2;
  for (int dd = 1; dd <= last; ++dd) {
    const int bs = base[dd];
    const int d1 = bs - base[dd - 1];
    const int d2 = bs - base[dd >= 2 ? dd - 2 : 0];
    int* Hc = st + (dd % 3) * W;
    const int* H1 = st + ((dd + 2) % 3) * W;
    const int* H2 = st + ((dd + 1) % 3) * W;
    int* Ec = st + (3 + (dd & 1)) * W;
    const int* E1 = st + (3 + ((dd + 1) & 1)) * W;
    int* Fc = st + (5 + (dd & 1)) * W;
    const int* F1 = st + (5 + ((dd + 1) & 1)) * W;
    uint8_t* mrow = mv + static_cast<size_t>(dd) * W;

    for (int l = threadIdx.x; l < W; l += blockDim.x) {
      const int i = bs + l;
      const int j = dd - i;
      const bool in1 = i >= 1 && i <= len1;
      const bool in2 = j >= 1 && j <= len2;
      bool interior = in1 && in2;
      if (band > 0) {
        const long long li = i, lj = j;
        interior = interior && (lj - band) * len1 <= li * len2 &&
                   li * len2 <= (lj + band + 1) * len1 - 1;
      }
      const bool boundary =
          (i == 0 && j >= 0 && j <= len2) || (j == 0 && i <= len1);
      const bool valid = interior || boundary;

      // E: gap in s1 (left), predecessor (i, j-1) on diagonal d-1
      const int e_open = load(H1, W, l + d1) - gopen;
      const int e_ext = load(E1, W, l + d1) - gap_ext;
      const int e = max(e_open, e_ext);
      // F: gap in s2 (up), predecessor (i-1, j) on diagonal d-1
      const int f_open = load(H1, W, l + d1 - 1) - gopen;
      const int f_ext = load(F1, W, l + d1 - 1) - gap_ext;
      const int f = max(f_open, f_ext);
      // diagonal: (i-1, j-1) on diagonal d-2 plus the substitution score
      const bool ismatch = in1 && in2 && s1[i - 1] == s2[j - 1];
      const int g = load(H2, W, l + d2 - 1) + (ismatch ? match : mismatch);

      // H: the traceback's tie-break, diag > up > left
      const int h_no_e = max(g, f);
      const uint8_t layer = e > h_no_e ? kLeft : (f > g ? kUp : kDiag);
      int h = max(h_no_e, e);
      if (boundary) h = 0;
      if (!valid) h = kNeg;

      Hc[l] = h;
      Ec[l] = e;
      Fc[l] = f;
      mrow[l] = layer | static_cast<uint8_t>((e_open >= e_ext) << 2) |
                static_cast<uint8_t>((f_open >= f_ext) << 3);
      if (valid && i == len1 && h >= trk[0]) {
        trk[0] = h;
        trk[1] = j;
        trk[2] = dd;
      }
      if (valid && j == len2 && h >= trk[3]) {
        trk[3] = h;
        trk[4] = i;
        trk[5] = dd;
      }
    }
    __syncthreads();
  }

  if (threadIdx.x < 16) {
    const int c = threadIdx.x;
    best[static_cast<size_t>(b) * 16 + c] =
        c < 3 ? trk[c] : (c >= 8 && c < 11 ? trk[c - 5] : 0);
  }
  if (threadIdx.x != 0) return;

  // traceback: the automaton of ops/align.py::traceback_moves, one op per
  // anti-diagonal (state 0 H, 1 E, 2 F)
  const bool use_row = trk[0] >= trk[3];
  if ((use_row ? trk[0] : trk[3]) <= kNeg) return;
  int i = use_row ? len1 : trk[4];
  int j = use_row ? trk[1] : len2;
  int state = 0;
  uint8_t* out = ops + static_cast<size_t>(b) * dpad;
  while (i >= 1 && j >= 1) {
    const int dd = i + j;
    const int lane = i - base[dd];
    if (lane < 0 || lane >= W) break;
    const uint8_t m = mv[static_cast<size_t>(dd) * W + lane];
    if (state == 0) {
      const uint8_t layer = m & 3;
      if (layer == kDiag) {
        out[dd] = kDiag;
        --i;
        --j;
        continue;
      }
      state = layer == kLeft ? 1 : 2;
    }
    if (state == 1) {
      out[dd] = kLeft;
      --j;
      if (m & 4) state = 0;
    } else {
      out[dd] = kUp;
      --i;
      if (m & 8) state = 0;
    }
  }
}

}  // namespace

extern "C" {

// Sets *ints to 0 when one block's DP state at window width W fits in the
// shared memory of `device`, else to the int32 count of global scratch each
// block needs.  Returns the CUDA error code of the device query.
int ngsid_moves_scratch_ints(int W, int device, int* ints) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long state = static_cast<long long>(kBuffers) * W;
  const long long bytes =
      state * static_cast<long long>(sizeof(int)) + kTrackerBytes;
  *ints = bytes <= limit ? 0 : static_cast<int>(state);
  return 0;
}

// Launches one block per pair on `stream`.  `store` holds B * (D + 1) * W
// bytes, where D >= max(len1 + len2); `ops` holds B * dpad zeroed bytes.
// With scratch == nullptr the DP state lives in dynamic shared memory;
// otherwise `scratch` holds B blocks of ngsid_moves_scratch_ints(W) int32.
// Returns cudaGetLastError() after the launch.
int ngsid_moves_launch(const void* pool, const void* pm, const void* base,
                       void* store, void* ops, void* best, void* scratch,
                       int B, int W, int D, int dpad, int band, int match,
                       int mismatch, int gap_ext, void* stream) {
  if (B <= 0) return 0;
  const int smem_bytes =
      scratch ? 0 : static_cast<int>(kBuffers * W * sizeof(int));
  if (smem_bytes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        moves_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = W < kMaxThreads ? W : kMaxThreads;
  moves_kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const long long*>(pm),
      static_cast<const int*>(base), static_cast<uint8_t*>(store),
      static_cast<uint8_t*>(ops), static_cast<int*>(best),
      static_cast<int*>(scratch), W, D, dpad, band, match, mismatch, gap_ext);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
