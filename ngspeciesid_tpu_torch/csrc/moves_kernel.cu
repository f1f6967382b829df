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
// What bounds it on an H100: not FLOPs.  The forward sweep is a chain of
// len1 + len2 dependent anti-diagonals per pair (latency-bound); the least
// time is set by bytes, one move byte per in-band cell that must reach
// device memory, since the traceback runs after the sweep.
//
// Design: the forward sweep is wavefront.cuh's with scores only (H, E, F
// one int each): the window's lanes in registers, L = 2, 4 or 8 lanes per
// thread, neighbour cells by warp shuffles, no block barrier per diagonal;
// memory mode for windows too wide for one block.  The cell, the move store
// and the warp-batched traceback are moves_policy.cuh's MovesK<false>: the
// window follows the host's schedule base[d].
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC (ops/cuda_lib.py), loaded with ctypes.

#include "moves_policy.cuh"

namespace {

using MovesK = wf_moves::MovesK<false>;

}  // namespace

extern "C" {

// int32 of global scratch one pair needs in memory mode at window width W.
int ngsid_moves_state_ints(int W) {
  return wf::kBuffers * MovesK::kFields * W;
}

// Launches the moves DP and traceback of B pairs on `stream`: lanes per
// thread (2, 4 or 8; memory == 0) or memory mode (memory == 1, lanes 1,
// warps 8, pairs 1, scratch of B * ngsid_moves_state_ints(W) int32),
// `warps` warps per pair and `pairs` pairs per block
// (ops/cuda_lib.py::launch_geometry).  `store` holds B * (d_max + 1) * W
// bytes, where d_max >= max(len1 + len2); `ops` holds B * dpad zeroed
// bytes.  trace == 0 skips the traceback (ops stay zero): the forward
// sweep's time alone.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a geometry the kernel does not take.
int ngsid_moves_launch(const void* pool, const void* pm, const void* base,
                       void* store, void* ops, void* best, void* scratch,
                       int B, int W, int d_max, int dpad, int band, int match,
                       int mismatch, int gap_ext, int lanes, int warps,
                       int pairs, int memory, int trace, void* stream) {
  wf::Launch a{};
  a.pool = static_cast<const uint8_t*>(pool);
  a.pm = static_cast<const long long*>(pm);
  a.base = static_cast<const int*>(base);
  a.out = static_cast<int*>(best);
  a.store = static_cast<uint8_t*>(store);
  a.ops = static_cast<uint8_t*>(ops);
  a.scratch = static_cast<int*>(scratch);
  a.B = B;
  a.W = W;
  a.dmax = d_max;
  a.dpad = dpad;
  a.band = band;
  a.match = match;
  a.mismatch = mismatch;
  a.gap_ext = gap_ext;
  a.nw = warps;
  a.pairs = pairs;
  a.trace = trace;
  return wf::launch<MovesK, 2, 4, 8>(a, lanes, memory, wf_moves::kTraceBytes,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
