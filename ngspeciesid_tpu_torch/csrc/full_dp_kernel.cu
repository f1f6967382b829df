// Full (unbanded) semi-global Gotoh DP with an on-device traceback: one op
// stream per pair.
//
// Replaces the TPU kernel ngspeciesid_tpu/ops/align_pallas.py (_kernel,
// launched by _pallas_dp) with the same int32 recurrence, move bits,
// tie-breaks and endpoint rule.  The TPU kernel ships the whole move matrix
// to the host, which traces it back (_traceback_diag); this kernel traces
// on the card and writes, per pair, the endpoint trackers into best (B, 16)
// int32 (row score, j, diagonal at columns 0-2; column score, i, diagonal
// at columns 8-10; zeros elsewhere) and one op per anti-diagonal of the
// optimal path into ops (B, d_max + 1) uint8 (DIAG 1, UP 2, LEFT 3; 0
// elsewhere).  ops/align_moves.py::_reconstruct adds the terminal gaps on
// the host.
//
// What bounds it on an H100: the integer operations of the cells (~13 per
// cell over len1 x len2 cells), then the move byte of every cell, which
// must reach device memory before the traceback can start.  The sweep
// itself is a chain of len1 + len2 dependent anti-diagonals per pair, so
// what it takes in practice is the instructions a thread issues per
// diagonal.
//
// Design: the full DP is wavefront.cuh's sweep in a fixed frame with the
// moves kernel's policy, moves_policy.cuh's MovesK<true>: the window is
// W = lanes_for(n) lanes (a multiple of 128, > every len1) with base 0 on
// every diagonal, so lane l is row i = l, and that is a compile-time
// property of the instantiation: no schedule is read (base is null), no
// band bounds are computed, only the unshifted step is instantiated, and
// the traceback takes the path's lane to be its row.  Register mode (L = 2,
// 4 or 8 lanes per thread in registers, neighbour cells by warp shuffles, a
// named barrier of the pair's warps only) covers W <= 4096: a warp whose
// rows [r0, r0 + 32 L) hold no cell of diagonal d (d < r0, or d past
// r0 + 32 L - 1 + len2, or r0 > len1: about a third of the warp-diagonals
// at the polish shape) skips the cells and only publishes its edge and
// meets its barrier (1.221 ms per 512-pair polish launch against 1.452
// with every warp computing every diagonal, on an H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 2c, PERF.md); memory mode (the state in a global
// slab) covers wider windows, so any s1 length runs.
// The move store is device scratch that the caller allocates and never
// copies to the host: only best and ops leave the card, O(n + m) bytes a
// pair instead of the (n + m) x W move matrix.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (ops/cuda_lib.py), loaded with ctypes.

#include "moves_policy.cuh"

namespace {

using FullK = wf_moves::MovesK<true>;

}  // namespace

extern "C" {

// Launches the full DP and traceback of B pairs on `stream`: lanes per
// thread (2, 4 or 8; memory == 0) or memory mode (memory == 1, lanes 1,
// warps 8, pairs 1, scratch of B * ngsid_moves_state_ints(W) int32),
// `warps` warps per pair and `pairs` pairs per block
// (ops/cuda_lib.py::launch_geometry("moves", ...)).  pool: uint8
// sequences; pm: (B, 8) int64 rows [len1, len2, gap_open, -, -, off1, off2,
// -]; W > every len1 and d_max >= every len1 + len2.  `store` holds
// B * (d_max + 1) * W bytes of scratch; `ops` holds B * (d_max + 1) zeroed
// bytes; `best` B * 16 int32.  trace == 0 skips the traceback (ops stay
// zero): the forward sweep's time alone.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a geometry the kernel does not
// take.
int ngsid_full_dp_launch(const void* pool, const void* pm, void* store,
                         void* ops, void* best, void* scratch, int B, int W,
                         int d_max, int match, int mismatch, int gap_ext,
                         int lanes, int warps, int pairs, int memory,
                         int trace, void* stream) {
  wf::Launch a{};
  a.pool = static_cast<const uint8_t*>(pool);
  a.pm = static_cast<const long long*>(pm);
  a.base = nullptr;
  a.out = static_cast<int*>(best);
  a.store = static_cast<uint8_t*>(store);
  a.ops = static_cast<uint8_t*>(ops);
  a.scratch = static_cast<int*>(scratch);
  a.B = B;
  a.W = W;
  a.dmax = d_max;
  a.dpad = d_max + 1;
  a.band = 0;
  a.match = match;
  a.mismatch = mismatch;
  a.gap_ext = gap_ext;
  a.nw = warps;
  a.pairs = pairs;
  a.trace = trace;
  return wf::launch<FullK, 2, 4, 8>(a, lanes, memory, wf_moves::kTraceBytes,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
