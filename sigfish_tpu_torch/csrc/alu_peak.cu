// ALU-rate probe for the wavefront's op mix, for Hopper (sm_90a).
//
// Replaces the TPU microbenchmark scripts/bench_vpu_peak.py::peak_kernel.
// It measures, on dummy data, the rate at which the card runs the
// operations of the wavefront sDTW step (csrc/wavefront.cu) in that
// kernel's own layout: a (B, 256) f32 plane, one warp per row, 8 values per
// lane, the lane roll as a register shift plus one __shfl_sync. Each launch
// runs `iters` loop-carried bodies of one mode:
//
//   add, min, select  CH = 4 chains that feed each other in pairs
//                     (a0 = op(a0, a1); a1 = op(a1, a0)): 4 ops per value
//   roll              each of the 4 chains rolled by one lane: 4 ops
//   mix               the wavefront's 8-op step (roll, 2 min, 2 select,
//                     sub, abs, add) as one loop-carried chain: 8 ops
//   mix2              two such chains, interleaved: 16 ops
//
// and writes the sum of the chains, so nothing is dead. mix2 / mix says
// whether the step's recurrence latency (mix2 faster) or the issue rate
// (no gain) limits the mix at this occupancy.
//
// Each chain update passes through an empty asm statement that the
// compiler cannot see through, so min(a1, min(a0, a1)) and
// m ? (m ? a1 : a0) : a1, which are algebraically a0' and a1, are still
// computed as written; the statement emits no instruction.
//
// What bounds it: ALU issue, by design; its memory traffic is one read and
// one write of the plane per launch. Build with -fmad=false and without
// --use_fast_math, like the wavefront: the values are held bit for bit to
// the plain PyTorch version (ops/alu_peak.py).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;  // values per lane: Q = 256
constexpr int kQ = 32 * kRows;
constexpr int kCh = 4;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kAdd = 0, kMin = 1, kSelect = 2, kRoll = 3, kMix = 4, kMix2 = 5 };

__device__ __forceinline__ void opaque(float (&v)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) asm volatile("" : "+f"(v[r]));
}

// v rolled by one position along the row: v'[i] = v[i-1], v'[0] = v[Q-1]
__device__ __forceinline__ void roll1(const float (&v)[kRows], float (&o)[kRows], int src) {
  const float in = __shfl_sync(kFull, v[kRows - 1], src);
#pragma unroll
  for (int r = kRows - 1; r > 0; --r) o[r] = v[r - 1];
  o[0] = in;
}

// one mix step on the chain (a1, b2): transcribed from bench_vpu_peak.py
__device__ __forceinline__ void mix_step(float (&a1)[kRows], float (&b2)[kRows],
                                         const float (&b)[kRows], const bool (&m)[kRows],
                                         int src) {
  float up[kRows];
  roll1(a1, up, src);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float ld = m[r] ? b[r] : fminf(a1[r], b2[r]);
    const float local = fabsf(a1[r] - b[r]);
    const float an = local + fminf(up[r], ld);
    a1[r] = m[r] ? local : an;
    b2[r] = up[r];
  }
}

template <int MODE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
alu_peak_kernel(const float* __restrict__ x, float* __restrict__ out, int B, int iters) {
  const int t = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warp leaves
  const int src = (t + 31) & 31;
  const size_t o = (size_t)row * kQ + t * kRows;

  float a[kCh][kRows], b[kRows];
  bool m[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = x[o + r];
#pragma unroll
    for (int c = 0; c < kCh; ++c) a[c][r] = v + (float)c;
    b[r] = v * 0.5f;
    m[r] = v > 0.5f;
  }

#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
    if (MODE == kAdd || MODE == kMin || MODE == kSelect) {
#pragma unroll
      for (int c = 0; c < kCh; c += 2) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (MODE == kAdd) a[c][r] = a[c][r] + a[c + 1][r];
          if (MODE == kMin) a[c][r] = fminf(a[c][r], a[c + 1][r]);
          if (MODE == kSelect) a[c][r] = m[r] ? a[c + 1][r] : a[c][r];
        }
        opaque(a[c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (MODE == kAdd) a[c + 1][r] = a[c + 1][r] + a[c][r];
          if (MODE == kMin) a[c + 1][r] = fminf(a[c + 1][r], a[c][r]);
          if (MODE == kSelect) a[c + 1][r] = m[r] ? a[c][r] : a[c + 1][r];
        }
        opaque(a[c + 1]);
      }
    } else if (MODE == kRoll) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        float rolled[kRows];
        roll1(a[c], rolled, src);
#pragma unroll
        for (int r = 0; r < kRows; ++r) a[c][r] = rolled[r];
        opaque(a[c]);
      }
    } else {
      mix_step(a[0], a[1], b, m, src);
      opaque(a[0]);
      opaque(a[1]);
      if (MODE == kMix2) {
        mix_step(a[2], a[3], b, m, src);
        opaque(a[2]);
        opaque(a[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float acc = a[0][r];
#pragma unroll
    for (int c = 1; c < kCh; ++c) acc = acc + a[c][r];
    out[o + r] = acc;
  }
}

}  // namespace

// C entry, bound with ctypes: x and out are (B, 256) f32 on the card.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError()
// (0 on success).
extern "C" int sf_alu_peak(const float* x, float* out, int B, int Q, int mode,
                           int iters, void* stream) {
  if (Q != kQ || iters < 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kAdd: alu_peak_kernel<kAdd><<<grid, block, 0, s>>>(x, out, B, iters); break;
    case kMin: alu_peak_kernel<kMin><<<grid, block, 0, s>>>(x, out, B, iters); break;
    case kSelect: alu_peak_kernel<kSelect><<<grid, block, 0, s>>>(x, out, B, iters); break;
    case kRoll: alu_peak_kernel<kRoll><<<grid, block, 0, s>>>(x, out, B, iters); break;
    case kMix: alu_peak_kernel<kMix><<<grid, block, 0, s>>>(x, out, B, iters); break;
    case kMix2: alu_peak_kernel<kMix2><<<grid, block, 0, s>>>(x, out, B, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
