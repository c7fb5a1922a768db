// The pore-model trainer's gap-penalised subsequence DTW, batched, for
// Hopper (sm_90a).
//
// Replaces the numpy host code sigfish_tpu/models/train_model.py::
// _subsequence_cost_gap (:168) and _backtrack_gap (:206), as _dtw_pairs
// runs them in each EM iteration's E-step (ops/train_dtw.py has the
// wrapper and the plain PyTorch version). Case b's rows x[b, :n] are the
// dwell-expanded k-mer levels, its columns y[b, :m] the read's events;
// the cost matrix is column-major in device memory, column j of case b at
// cost + (b*M + j)*N, and never leaves the card: only the path does.
//
// The JAX function computes each column by the prefix-min identity
//   s   = cumsum(|x - y_j|)                          (sequential f32)
//   t_i = (min(prev_i + gl, prev_{i-1}) - s_{i-1}) - iu_i,   t_0 = 0
//   col = (s + iu) + cummin(t),   col_0 = |x_0 - y_j|
// with iu_i = f32(f64(i) * f64(gu)) and the first column
// cumsum(|x - y_0| + gu) - gu. Three launches keep that order exactly:
//
//   gap_prefix  a thread a column: s down the column, sequential in f32 as
//               numpy's float32 cumsum is (a parallel scan would reorder
//               the adds), written where the column's costs will go; the
//               thread of column 0 writes the first column itself
//   gap_sweep   a block of 256 threads a case, sweeping its columns in
//               order; each thread owns a contiguous run of rows, takes
//               its run's minimum of t, a warp-shuffle and shared-memory
//               scan gives each run the minimum of the runs above, and a
//               second pass over the run writes the costs (min is exact,
//               so the scan's grouping changes no bit). Two barriers a
//               column.
//   gap_path    a thread a case: the first argmin of the last row, then
//               the greedy walk (diag if it is the minimum, else left,
//               else up; up and left add their f32 gap).
//
// What bounds it: the sweep is a chain of m dependent columns a case, each
// a few hundred cycles of barrier and shuffle latency; the bytes (each
// cell written twice and read about three times) are a small share of it.
// Build with -fmad=false and without --use_fast_math: every value is held
// bit for bit to the plain version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSweepThreads = 256;
constexpr int kWarps = kSweepThreads / 32;
constexpr int kThreads = 256;
// a walk is one thread's chain of dependent loads: one warp a block
// spreads the walks over the SMs
constexpr int kPathThreads = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float up_ramp(int i, float gu) {
  return (float)((double)i * (double)gu);
}

__global__ void __launch_bounds__(kThreads)
gap_prefix(const float* __restrict__ x, const float* __restrict__ y,
           const int* __restrict__ nn, const int* __restrict__ mm, int B, int N, int M,
           float gu, float* __restrict__ cost) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(t / M), j = (int)(t % M);
  if (b >= B) return;
  const int n = nn[b];
  if (j >= mm[b] || n <= 0) return;
  const float* xb = x + (size_t)b * N;
  const float yj = y[(size_t)b * M + j];
  float* C = cost + ((size_t)b * M + j) * N;
  if (j == 0) {
    float acc = fabsf(xb[0] - yj) + gu;
    C[0] = acc - gu;
    for (int i = 1; i < n; ++i) {
      acc = acc + (fabsf(xb[i] - yj) + gu);
      C[i] = acc - gu;
    }
  } else {
    float acc = fabsf(xb[0] - yj);
    C[0] = acc;
    for (int i = 1; i < n; ++i) {
      acc = acc + fabsf(xb[i] - yj);
      C[i] = acc;
    }
  }
}

// t_i of column j from the previous column P, s_{i-1} = sp (i >= 1)
__device__ __forceinline__ float gap_t(const float* P, int i, float sp, float gu, float gl) {
  const float mm = fminf(P[i] + gl, P[i - 1]);
  return (mm - sp) - up_ramp(i, gu);
}

__global__ void __launch_bounds__(kSweepThreads)
gap_sweep(const float* __restrict__ x, const float* __restrict__ y,
          const int* __restrict__ nn, const int* __restrict__ mm, int N, int M, float gu,
          float gl, float* __restrict__ cost) {
  const int b = blockIdx.x;
  const int n = nn[b], m = mm[b];
  if (n <= 0 || m <= 1) return;  // the whole block leaves
  __shared__ float warp_min[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int run = (n + kSweepThreads - 1) / kSweepThreads;
  const int i0 = min(n, (int)threadIdx.x * run), i1 = min(n, i0 + run);
  const float x0 = x[(size_t)b * N];
  const float* yb = y + (size_t)b * M;
  float* Cb = cost + (size_t)b * M * N;
  for (int j = 1; j < m; ++j) {
    const float* P = Cb + (size_t)(j - 1) * N;
    float* S = Cb + (size_t)j * N;  // holds s until this column's costs replace it
    // s_{i0-1} belongs to the run above, which overwrites it after the
    // barrier: read it first
    const float s_above = (i0 > 0 && i0 < i1) ? S[i0 - 1] : 0.f;
    float lo = INFINITY, sp = s_above;
    for (int i = i0; i < i1; ++i) {
      const float si = S[i];
      lo = fminf(lo, i == 0 ? 0.f : gap_t(P, i, sp, gu, gl));
      sp = si;
    }
    // inclusive min-scan of the runs' minima over the block
    float v = lo;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = fminf(v, u);
    }
    if (lane == 31) warp_min[warp] = v;
    __syncthreads();
    float h = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) h = INFINITY;
    for (int w = 0; w < warp; ++w) h = fminf(h, warp_min[w]);
    sp = s_above;
    for (int i = i0; i < i1; ++i) {
      const float si = S[i];
      h = fminf(h, i == 0 ? 0.f : gap_t(P, i, sp, gu, gl));
      S[i] = i == 0 ? fabsf(x0 - yb[j]) : (si + up_ramp(i, gu)) + h;
      sp = si;
    }
    __syncthreads();  // column j is read whole by column j + 1; warp_min reused
  }
}

__global__ void __launch_bounds__(kPathThreads)
gap_path(const float* __restrict__ cost, const int* __restrict__ nn,
         const int* __restrict__ mm, int B, int N, int M, float gu, float gl,
         int* __restrict__ end, float* __restrict__ end_cost, int* __restrict__ px,
         int* __restrict__ py, int* __restrict__ plen) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = nn[b], m = mm[b];
  if (n <= 0 || m <= 0) {
    end[b] = -1;
    end_cost[b] = 0.f;
    plen[b] = 0;
    return;
  }
  const float* C = cost + (size_t)b * M * N;
  int e = 0;
  float best = C[n - 1];
  for (int j = 1; j < m; ++j) {
    const float v = C[(size_t)j * N + n - 1];
    if (v < best) {
      best = v;
      e = j;
    }
  }
  end[b] = e;
  end_cost[b] = best;
  int* ox = px + (size_t)b * (N + M);
  int* oy = py + (size_t)b * (N + M);
  int i = n - 1, j = e, k = 0;
  ox[k] = i;
  oy[k] = j;
  ++k;
  while (i > 0) {  // a path stops on reaching row 0 (free start)
    if (j == 0) {
      --i;
    } else {
      const float up = C[(size_t)j * N + i - 1] + gu;
      const float diag = C[(size_t)(j - 1) * N + i - 1];
      const float left = C[(size_t)(j - 1) * N + i] + gl;
      const float mn = fminf(up, fminf(diag, left));
      if (diag == mn) {
        --i;
        --j;
      } else if (left == mn) {
        --j;
      } else {
        --i;
      }
    }
    ox[k] = i;
    oy[k] = j;
    ++k;
  }
  plen[b] = k;
}

}  // namespace

// C entries, bound with ctypes. x (B, N) and y (B, M) f32, n and m (B,)
// i32 on the card; cost holds B*M*N f32. Each launches on `stream`,
// allocates nothing and returns cudaGetLastError() (0 on success).
extern "C" int sf_gap_dtw(const float* x, const float* y, const int* n, const int* m, int B,
                          int N, int M, float gu, float gl, float* cost, void* stream) {
  if (B < 0 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t cols = (int64_t)B * M;
  gap_prefix<<<(unsigned)((cols + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      x, y, n, m, B, N, M, gu, cost);
  gap_sweep<<<B, kSweepThreads, 0, s>>>(x, y, n, m, N, M, gu, gl, cost);
  return (int)cudaGetLastError();
}

// end (B,) i32, end_cost (B,) f32, px and py (B, N + M) i32 in walk order,
// plen (B,) i32.
extern "C" int sf_gap_path(const float* cost, const int* n, const int* m, int B, int N, int M,
                           float gu, float gl, int* end, float* end_cost, int* px, int* py,
                           int* plen, void* stream) {
  if (B < 0 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  gap_path<<<(B + kPathThreads - 1) / kPathThreads, kPathThreads, 0, (cudaStream_t)stream>>>(
      cost, n, m, B, N, M, gu, gl, end, end_cost, px, py, plen);
  return (int)cudaGetLastError();
}
