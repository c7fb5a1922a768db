// The column-scan subsequence DTW engine, batched, for Hopper (sm_90a).
//
// Replaces the XLA lax.scan of sigfish_tpu/ops/sdtw.py::sdtw_scan (:82),
// with its column updates _column_update (:55) and _column_update_std
// (:67); ops/sdtw_scan.py has the wrapper and the plain PyTorch version.
// Read b's query x[b, :Q] runs against one concatenated reference y (R,)
// with reset flags (R,) at each track's first column. The carry c is the
// DP column at j - 1 (BIG = 3.0e38 at the start and at every reset; never
// inf, so BIG - s stays finite). Column j, with local = |x - y_j|:
//   s[i]   = local[0] + ... + local[i]
//   t[0]   = 0 (std: p0 = reset ? 0 : c[0]),  t[i] = min(c[i], c[i-1]) - s[i-1]
//   new[i] = s[i] + min(t[0], ..., t[i])
// and out[b, j] = new[row_b], row_b = qlen_b - 1 (out 0 where row_b < 0).
//
// One warp a read, its Q = 32 * ROWS rows in 32 contiguous runs, ROWS a
// lane, the query and the carry in registers. Each column:
//   1. the lane's run sums in row order, then a 5-step __shfl_up_sync
//      Hillis-Steele scan of the 32 run totals (offsets 1, 2, 4, 8, 16),
//      and each row adds its run's exclusive prefix: s;
//   2. c_up and s[i-1] of a run's first row from the lane above (one
//      shuffle each; row 0 takes t[0] instead);
//   3. t, the run's prefix min in row order, the same warp scan under
//      fminf, each row's min with its run's exclusive prefix: g;
//   4. new = s + g, and the lane holding row_b stores it at (b, j).
// Only the sum's order changes bits (min is exact in any order), and
// that order is the plain version's: the two agree bit for bit. The sums
// of column j + 1 do not depend on the carry, so each iteration computes
// them beside column j's min chain, and the two chains' shuffles overlap.
//
// Modes: one-shot (init null: the carry starts BIG) and carry (an
// initial (B, Q) column); the final column goes to final_col when given,
// so segments chained through it equal one scan over their concatenation.
//
// What bounds it: R dependent column steps a read, each two chains of
// ROWS f32 operations and six shuffles (~23 cycles each), far from the
// issue rate; B = 512 reads are 4 warps an SM, one a scheduler. The
// bytes are the (B, R) output, 4 B a cell-column. A later design could
// put several reads in a warp or split the runs over warps.
// Build with -fmad=false and without --use_fast_math.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

// this lane's rows of s for column value y
template <int ROWS>
__device__ __forceinline__ void column_sums(const float (&x)[ROWS], float y, int lane,
                                            float (&s)[ROWS]) {
  s[0] = fabsf(x[0] - y);
#pragma unroll
  for (int k = 1; k < ROWS; ++k) s[k] = s[k - 1] + fabsf(x[k] - y);
  float v = s[ROWS - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, v, off);
    v = lane >= off ? v + o : v;
  }
  float e = __shfl_up_sync(kFull, v, 1);
  e = lane == 0 ? 0.f : e;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) s[k] = s[k] + e;
}

template <int ROWS, bool STD>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    scan_kernel(const float* __restrict__ q, const int* __restrict__ lrow,
                const float* __restrict__ ref, const unsigned char* __restrict__ reset,
                const float* __restrict__ init, float* __restrict__ out,
                float* __restrict__ final_col, int B, int R) {
  constexpr int Q = 32 * ROWS;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  const int base = lane * ROWS;
  const size_t qo = (size_t)b * Q + base;
  float x[ROWS], c[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    x[k] = q[qo + k];
    c[k] = init ? init[qo + k] : kBig;
  }
  const int row = lrow[b];
  const bool owner = row < 0 ? lane == 0 : (row >= base && row < base + ROWS);
  const int kk = row - base;
  float* ob = out + (size_t)b * R;
  // the loop body is one basic block, so the compiler interleaves column
  // j + 1's sums with column j's min chain; the reference value is
  // loaded two columns ahead and the reset flag one
  float s[ROWS];
  float y1 = 0.f, y2 = 0.f;
  bool rs = false;
  if (R > 0) {
    column_sums(x, ref[0], lane, s);
    y1 = ref[min(1, R - 1)];
    rs = reset[0] != 0;
  }
  for (int j = 0; j < R; ++j) {
    y2 = ref[min(j + 2, R - 1)];
    const bool rs1 = reset[min(j + 1, R - 1)] != 0;
    float sn[ROWS];
    column_sums(x, y1, lane, sn);
    const float p0 = STD && !rs ? c[0] : 0.f;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) c[k] = rs ? kBig : c[k];
    const float c_above = __shfl_up_sync(kFull, c[ROWS - 1], 1);
    const float s_above = __shfl_up_sync(kFull, s[ROWS - 1], 1);
    float t[ROWS];
    t[0] = lane == 0 ? p0 : fminf(c[0], c_above) - s_above;
#pragma unroll
    for (int k = 1; k < ROWS; ++k) t[k] = fminf(c[k], c[k - 1]) - s[k - 1];
#pragma unroll
    for (int k = 1; k < ROWS; ++k) t[k] = fminf(t[k - 1], t[k]);
    float h = t[ROWS - 1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(kFull, h, off);
      h = lane >= off ? fminf(h, o) : h;
    }
    float g = __shfl_up_sync(kFull, h, 1);
    g = lane == 0 ? INFINITY : g;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      c[k] = s[k] + fminf(g, t[k]);
      v = k == kk ? c[k] : v;
      s[k] = sn[k];
    }
    if (owner) ob[j] = v;
    y1 = y2;
    rs = rs1;
  }
  if (final_col) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) final_col[qo + k] = c[k];
  }
}

template <int ROWS>
cudaError_t launch(const float* q, const int* lrow, const float* ref, const unsigned char* reset,
                   const float* init, float* out, float* final_col, int B, int R, bool std_,
                   void* stream) {
  void (*kernel)(const float*, const int*, const float*, const unsigned char*, const float*,
                 float*, float*, int, int) =
      std_ ? scan_kernel<ROWS, true> : scan_kernel<ROWS, false>;
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<grid, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(q, lrow, ref, reset, init, out,
                                                                 final_col, B, R);
  return cudaGetLastError();
}

}  // namespace

// q (B, Q) f32, lrow (B,) i32 (the row to emit, -1 none), ref (R,) f32,
// reset (R,) u8, init (B, Q) f32 or null (BIG), out (B, R) f32, final_col
// (B, Q) f32 or null. Q = 32 * {1, 2, 4, 8, 12, 16}.
extern "C" int sf_sdtw_scan(const float* q, const int* lrow, const float* ref,
                            const unsigned char* reset, const float* init, float* out,
                            float* final_col, int B, int Q, int R, int std_, void* stream) {
  if (B < 0 || R < 0 || Q < 32 || Q % 32) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  switch (Q / 32) {
    case 1: return (int)launch<1>(q, lrow, ref, reset, init, out, final_col, B, R, std_, stream);
    case 2: return (int)launch<2>(q, lrow, ref, reset, init, out, final_col, B, R, std_, stream);
    case 4: return (int)launch<4>(q, lrow, ref, reset, init, out, final_col, B, R, std_, stream);
    case 8: return (int)launch<8>(q, lrow, ref, reset, init, out, final_col, B, R, std_, stream);
    case 12: return (int)launch<12>(q, lrow, ref, reset, init, out, final_col, B, R, std_, stream);
    case 16: return (int)launch<16>(q, lrow, ref, reset, init, out, final_col, B, R, std_, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
