// Full (unbanded) semi-global Gotoh DP: the whole packed move matrix of each
// pair in diagonal layout, and its endpoint trackers.
//
// Replaces the TPU kernel ngspeciesid_tpu/ops/align_pallas.py (_kernel,
// launched by _pallas_dp) with the same int32 semantics.  For each pair it
// writes one move byte per cell into moves (B, n + m, L) uint8, cell (i, j)
// at [i + j - 1, i]: the chosen H layer in bits 0-1 (DIAG 1, UP 2, LEFT 3),
// the E-open bit 2 and the F-open bit 3 for interior cells, 0 elsewhere; and
// [row_best, row_j, col_best, col_i] into best (B, 4) int32.  The host
// traces the moves back (ops/align.py::traceback_moves through
// ops/align_full.py::row_view).
//
// What bounds it on an H100: not FLOPs.  A pair is a chain of len1 + len2
// anti-diagonals, each depending on the two before it, so the sweep is
// latency-bound (one __syncthreads per diagonal).  The least time for the
// work itself is set by its integer operations, about 13 per cell, ahead of
// its bytes, one move byte per cell; this kernel also writes the padding of
// the diagonal layout (every lane of every diagonal), which the work does
// not need.
//
// Design:
//   * One thread block per pair, threads along the lane index i = 0..L-1
//     (at most 1024 threads; a thread owns lanes t, t + T, ..., at most 8).
//   * E comes from the same lane on the previous diagonal, so each thread
//     keeps its lanes' E in registers.  H at dd-1 and dd-2, and F at dd-1,
//     come from lane i - 1: they are shared-memory rows, rotated over three
//     H and two F buffers, so that the row diagonal dd writes is one that no
//     thread reads on dd, and one __syncthreads per diagonal suffices.
//   * s1 and s2 are staged in shared memory and s2 is indexed directly at
//     j - 1; the TPU's reversed, padded s2 row and its dynamic lane roll
//     were a TPU tactic and are gone.  H is NEG outside the pair's cells;
//     E and F are not masked, as on the TPU.
//   * The last-row cell of a diagonal is lane len1 and the last-column cell
//     lane dd - len2: the one thread owning each updates a block tracker in
//     shared memory with ">=" (the later diagonal wins ties).
//   * Each diagonal's L move bytes are written as one coalesced row.  A
//     block stops at its pair's last diagonal len1 + len2 and zeroes the
//     remaining rows with 4-byte stores (L is a multiple of 128).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (ops/cuda_lib.py), loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNeg = -(1 << 30);   // ops/align.py NEG_INF
constexpr int kMaxThreads = 1024;
constexpr int kMaxLanesPerThread = 8;
constexpr uint8_t kDiag = 1, kUp = 2, kLeft = 3;

// s1: (B, n) uint8; s2: (B, m) uint8; meta: (B, 3) int32 rows
// [len1, len2, gap_open]; moves: (B, n + m, L) uint8; best: (B, 4) int32.
__global__ void __launch_bounds__(kMaxThreads)
full_dp_kernel(const uint8_t* __restrict__ s1, const uint8_t* __restrict__ s2,
               const int* __restrict__ meta, uint8_t* __restrict__ moves,
               int* __restrict__ best, int n, int m, int L, int match,
               int mismatch, int gap_ext) {
  extern __shared__ int smem[];
  __shared__ int trk[4];   // row score, j | column score, i

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int len1 = meta[b * 3];
  const int len2 = meta[b * 3 + 1];
  const int gopen = meta[b * 3 + 2];
  int* Hbuf = smem;                 // 3 rows of L: diagonal dd at dd % 3
  int* Fbuf = smem + 3 * L;         // 2 rows of L: diagonal dd at dd & 1
  uint8_t* s1s = reinterpret_cast<uint8_t*>(smem + 5 * L);  // lane i: s1[i-1]
  uint8_t* s2s = s1s + L;                                   // s2[0..len2)
  const size_t D = static_cast<size_t>(n) + m;
  uint8_t* mv = moves + static_cast<size_t>(b) * D * L;

  // diagonal 0 (H slot 0) holds only cell (0, 0), score 0; diagonal -1
  // (slot 2) and F of diagonal 0 (slot 0) are unreachable
  for (int l = t; l < L; l += T) {
    Hbuf[l] = l == 0 ? 0 : kNeg;
    Hbuf[L + l] = kNeg;
    Hbuf[2 * L + l] = kNeg;
    Fbuf[l] = kNeg;
    Fbuf[L + l] = kNeg;
    s1s[l] = (l >= 1 && l <= len1) ? s1[static_cast<size_t>(b) * n + l - 1]
                                   : 0;
  }
  for (int k = t; k < len2; k += T) {
    s2s[k] = s2[static_cast<size_t>(b) * m + k];
  }
  if (t < 4) trk[t] = (t % 2 == 0) ? kNeg : 0;
  int e[kMaxLanesPerThread];
#pragma unroll
  for (int k = 0; k < kMaxLanesPerThread; ++k) e[k] = kNeg;
  __syncthreads();

  const int last = len1 + len2;
  for (int dd = 1; dd <= last; ++dd) {
    int* Hc = Hbuf + (dd % 3) * L;
    const int* H1 = Hbuf + ((dd + 2) % 3) * L;
    const int* H2 = Hbuf + ((dd + 1) % 3) * L;
    int* Fc = Fbuf + (dd & 1) * L;
    const int* F1 = Fbuf + ((dd + 1) & 1) * L;
    uint8_t* row = mv + static_cast<size_t>(dd - 1) * L;
#pragma unroll
    for (int k = 0; k < kMaxLanesPerThread; ++k) {
      const int i = t + k * T;
      if (i < L) {
        const int j = dd - i;
        const bool valid = i <= len1 && j >= 0 && j <= len2;
        const bool boundary = i == 0 || j == 0;
        const bool interior = valid && !boundary;
        // E: gap in s1 (left), predecessor (i, j-1) in this lane
        const int e_open = H1[i] - gopen;
        const int e_ext = e[k] - gap_ext;
        const int ev = max(e_open, e_ext);
        // F: gap in s2 (up), predecessor (i-1, j) in lane i - 1
        const int f_open = (i == 0 ? kNeg : H1[i - 1]) - gopen;
        const int f_ext = (i == 0 ? kNeg : F1[i - 1]) - gap_ext;
        const int fv = max(f_open, f_ext);
        // diagonal: (i-1, j-1) on diagonal dd-2 plus the substitution score
        const int sub = (interior && s1s[i] == s2s[j - 1]) ? match : mismatch;
        const int g = (i == 0 ? kNeg : H2[i - 1]) + sub;

        const int h_no_e = max(g, fv);
        int h = boundary ? 0 : max(h_no_e, ev);
        if (!valid) h = kNeg;
        const uint8_t layer = ev > h_no_e ? kLeft : (fv > g ? kUp : kDiag);
        Hc[i] = h;
        Fc[i] = fv;
        e[k] = ev;
        row[i] = interior
                     ? static_cast<uint8_t>(layer | ((e_open >= e_ext) << 2) |
                                            ((f_open >= f_ext) << 3))
                     : 0;
        if (valid && i == len1 && h >= trk[0]) {
          trk[0] = h;
          trk[1] = j;
        }
        if (valid && j == len2 && h >= trk[2]) {
          trk[2] = h;
          trk[3] = i;
        }
      }
    }
    __syncthreads();
  }

  // rows of diagonals past this pair's last hold no cell
  uint32_t* zero = reinterpret_cast<uint32_t*>(mv + static_cast<size_t>(last) * L);
  const size_t words = (D - last) * L / 4;
  for (size_t w = t; w < words; w += T) zero[w] = 0;
  if (t < 4) best[static_cast<size_t>(b) * 4 + t] = trk[t];
}

}  // namespace

extern "C" {

// Launches one block per pair on `stream`.  L (a multiple of 128, at least
// n + 1 and at most 1024 * 8) is the lane count; `moves` holds
// B * (n + m) * L bytes and `best` B * 4 int32.  Returns the CUDA error of
// the shared-memory setting or cudaGetLastError() after the launch.
int ngsid_full_dp_launch(const void* s1, const void* s2, const void* meta,
                         void* moves, void* best, int B, int n, int m, int L,
                         int match, int mismatch, int gap_ext, void* stream) {
  if (B <= 0) return 0;
  if (L % 128 != 0 || L < n + 1 || L > kMaxThreads * kMaxLanesPerThread) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_bytes = 5 * L * static_cast<int>(sizeof(int)) + L + m;
  const cudaError_t err = cudaFuncSetAttribute(
      full_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = L < kMaxThreads ? L : kMaxThreads;
  full_dp_kernel<<<B, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(s1), static_cast<const uint8_t*>(s2),
      static_cast<const int*>(meta), static_cast<uint8_t*>(moves),
      static_cast<int*>(best), n, m, L, match, mismatch, gap_ext);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
