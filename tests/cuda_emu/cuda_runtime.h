// A CPU stand-in for the CUDA runtime, enough to run the warp-level kernels
// (sigfish_tpu_torch/csrc/gap_dtw.cu, banded_dtw.cu, scan.cu, wavefront.cu)
// on the host in tests/test_torch_train_emulated.py,
// tests/test_torch_scan_emulated.py and tests/test_torch_wavefront.py:
// each block's threads are std::threads that run the kernel's code as
// written, a warp's 32 in lockstep at every shuffle, ballot and __syncwarp
// (a barrier exchange), the block's at __syncthreads. Blocks run one after
// another, the last first (the card runs them in no set order, so a kernel
// that leans on launch order fails here), so __shared__ variables are
// statics and the dynamic shared memory a buffer a block. The test rewrites
// each launch `k<<<grid, block, smem, stream>>>(args)` as
// `emu_launch(grid, block, smem, k, args)` and the one inline PTX line
// (wavefront.cu's mbarrier helpers call emu_mbar_* instead); it needs g++
// with C++20.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
};
struct dim3 {
  int x, y, z;
};
struct uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, sizeof f);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, sizeof i);
  return i;
}
inline int __vimin3_s32(int a, int b, int c) { return std::min(std::min(a, b), c); }
using std::max;
using std::min;

struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};
inline thread_local dim3 blockIdx, threadIdx, blockDim;
inline thread_local EmuWarp* emu_warp;
inline thread_local std::barrier<>* emu_block;
inline thread_local char* emu_smem;

template <class T>
T __shfl_sync(unsigned, T v, int src) {
  uint64_t u = 0;
  std::memcpy(&u, &v, sizeof v);
  emu_warp->slot[threadIdx.x & 31] = u;
  emu_warp->bar.arrive_and_wait();
  const uint64_t r = emu_warp->slot[src & 31];
  emu_warp->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof out);
  return out;
}
template <class T>
T __shfl_up_sync(unsigned mask, T v, int d) {
  const int lane = threadIdx.x & 31;
  return __shfl_sync(mask, v, lane - d < 0 ? lane : lane - d);
}
inline unsigned __ballot_sync(unsigned, int p) {
  emu_warp->slot[threadIdx.x & 31] = p != 0;
  emu_warp->bar.arrive_and_wait();
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= (unsigned)emu_warp->slot[l] << l;
  emu_warp->bar.arrive_and_wait();
  return r;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline void __syncwarp() { emu_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline void __threadfence_block() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline long long clock64() { return 0; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// An mbarrier of one word: bit 63 the phase, bits 32-62 the arrivals a
// phase expects, bits 0-31 those still pending. A wait on parity p returns
// once the phase of that parity has completed.
inline void emu_mbar_init(uint64_t* bar, unsigned count) {
  std::atomic_ref<uint64_t>(*bar).store(((uint64_t)count << 32) | count);
}
inline void emu_mbar_arrive(uint64_t* bar) {
  std::atomic_ref<uint64_t> a(*bar);
  uint64_t old = a.load(), nw;
  do {
    const uint64_t expected = (old >> 32) & 0x7fffffffu, pending = old & 0xffffffffu;
    nw = pending == 1 ? ((~old & (1ull << 63)) | (expected << 32) | expected) : old - 1;
  } while (!a.compare_exchange_weak(old, nw));
}
inline void emu_mbar_wait(uint64_t* bar, unsigned parity) {
  while ((std::atomic_ref<uint64_t>(*bar).load() >> 63) == parity) std::this_thread::yield();
}

template <class K, class... A>
void emu_launch(int grid, int block, size_t smem, K kernel, A... args);
template <class K, class... A>
void emu_launch(dim3 grid, dim3 block, size_t smem, K kernel, A... args) {
  emu_launch(grid.x, block.x, smem, kernel, args...);
}
template <class K, class... A>
void emu_launch(int grid, int block, size_t smem, K kernel, A... args) {
  for (int b = grid - 1; b >= 0; --b) {
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int w = 0; w < block / 32; ++w) warps.emplace_back(new EmuWarp);
    std::barrier<> bar(block);
    std::vector<char> shared(smem + 16);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        blockDim.x = block;
        emu_warp = warps[t / 32].get();
        emu_block = &bar;
        emu_smem = shared.data();
        kernel(args...);
      });
    for (auto& t : threads) t.join();
  }
}
