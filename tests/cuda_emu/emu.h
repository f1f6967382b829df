// A SIMT emulation of the CUDA features csrc/stats_kernel.cu and
// csrc/moves_kernel.cu use, for running their sources on a CPU with g++
// (tests/test_torch_cuda_emulated.py).  One OS thread per CUDA thread, the
// blocks of a launch one after another; warp shuffles, ballots and
// __syncwarp meet at a per-warp barrier, bar.sync at a per-id barrier of
// the given thread count, __shared__ variables are statics (one block runs
// at a time).  It checks the kernels' logic, not their speed, and not
// what only the card shows (memory ordering, occupancy, ptxas).
#pragma once
#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <thread>
#include <vector>

struct dim3v {
  unsigned x = 0, y = 0, z = 0;
};
extern thread_local dim3v threadIdx, blockIdx;
extern thread_local uint8_t* emu_dyn;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __shared__ static
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "emulated"; }
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
using std::max;
using std::min;
template <class T>
T __ldg(const T* p) {
  return *p;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }

// A barrier of n arrivals.  A kernel whose threads do not all arrive (a
// shuffle or bar.sync that diverges) would wait forever: after 60 s the
// process ends with a message, so a test run cannot hang on it.
struct Bar {
  std::mutex m;
  std::condition_variable cv;
  int count = 0;
  long gen = 0;
  void arrive(int n) {
    std::unique_lock<std::mutex> l(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      gen++;
      cv.notify_all();
    } else if (!cv.wait_for(l, std::chrono::seconds(60),
                            [&] { return gen != g; })) {
      std::fprintf(stderr, "emulated kernel: a barrier of %d threads was "
                           "not met in 60 s\n", n);
      std::_Exit(3);
    }
  }
};
struct Ctx {
  Bar wbar[32];
  Bar nbar[16];
  long long slots[32][32];
  std::mutex atom;
};
extern thread_local Ctx* emu_ctx;

inline void __syncwarp() { emu_ctx->wbar[threadIdx.x >> 5].arrive(32); }
inline void emu_bar(int id, int n) { emu_ctx->nbar[id].arrive(n); }
// every lane posts v, then reads lane src's (its own where src is outside
// the warp, as __shfl_up/down_sync return)
template <class T>
T emu_shfl(T v, int src) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  emu_ctx->slots[w][lane] = static_cast<long long>(v);
  emu_ctx->wbar[w].arrive(32);
  const T r =
      (src >= 0 && src < 32) ? static_cast<T>(emu_ctx->slots[w][src]) : v;
  emu_ctx->wbar[w].arrive(32);
  return r;
}
template <class T>
T __shfl_down_sync(unsigned, T v, int d) {
  return emu_shfl(v, static_cast<int>(threadIdx.x & 31) + d);
}
template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  return emu_shfl(v, static_cast<int>(threadIdx.x & 31) - d);
}
template <class T>
T __shfl_sync(unsigned, T v, int s) {
  return emu_shfl(v, s & 31);
}
inline unsigned __ballot_sync(unsigned, bool pred) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  emu_ctx->slots[w][lane] = pred ? 1 : 0;
  emu_ctx->wbar[w].arrive(32);
  unsigned r = 0;
  for (int t = 0; t < 32; ++t) r |= (emu_ctx->slots[w][t] ? 1u : 0u) << t;
  emu_ctx->wbar[w].arrive(32);
  return r;
}
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  std::lock_guard<std::mutex> g(emu_ctx->atom);
  const unsigned long long old = *p;
  if (v > old) *p = v;
  return old;
}

// kernel<<<grid, threads, smem, stream>>>(a)
template <class A>
void emu_launch(void (*f)(A), int grid, int threads, size_t smem, void*,
                const A& a) {
  for (int b = 0; b < grid; ++b) {
    Ctx ctx;
    std::vector<uint8_t> dyn(smem + 16);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t) {
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        emu_ctx = &ctx;
        emu_dyn = dyn.data();
        f(a);
      });
    }
    for (auto& t : ts) t.join();
  }
}
