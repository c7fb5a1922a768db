// The pore-model trainer's banded, end-anchored DTW, batched, for Hopper
// (sm_90a).
//
// Replaces the numpy host code sigfish_tpu/models/train_model.py::
// _banded_anchored_dtw (:419), which fit_model_banded runs for every read
// in each EM iteration's E-step (ops/train_dtw.py has the wrapper and the
// plain PyTorch version). Case b's rows ev[b, :n] are the read's events,
// its columns lvl[b, :m] the dwell-expanded levels; the cost and int8
// pointer matrices are row-major in device memory, case b at b*N*M, row
// stride M, and never leave the card: only the path does. The wrapper
// fills cost with BIGF = 3e37 and the pointers with 0 (diagonal), which is
// what every cell outside a row's band holds in the JAX function.
//
//   banded_dp    a thread a case, the JAX loop as it stands: row 0 takes
//                |ev_0 - lvl_j| for j < min(end_slack, m) within its band;
//                row i's band is (i*m)//n -/+ max(band, end_slack + 8);
//                each cell takes the diagonal first, then up (+gap_up)
//                only if strictly less, then left (+gap_left, BIGF at the
//                band's first cell) only if strictly less, and its
//                diagonal at column 0 is 0 while i <= end_slack (free
//                start), else BIGF
//   banded_path  a thread a case: the end cell is the first minimum of the
//                last row's last end_slack columns, then the last column's
//                last end_slack rows, in that order; then the pointer walk
//                back to row 0
//
// What bounds it: each case is a chain of about n * (2 * band + 1)
// dependent cells (the left move carries along the row), a few cycles of
// L1 latency each; there are as many chains as cases, far fewer than the
// card's schedulers hold, so the chain, not bytes or operations, sets the
// time. Build with -fmad=false and without --use_fast_math: every value
// is held bit for bit to the plain version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// one warp a block spreads the cases' chains over the SMs, each SM's L1
// holding its 32 cases' last rows
constexpr int kThreads = 32;
constexpr float kBigF = 3e37f;

__global__ void __launch_bounds__(kThreads)
banded_dp(const float* __restrict__ ev, const float* __restrict__ lvl,
          const int* __restrict__ nn, const int* __restrict__ mm, const int* __restrict__ band,
          int B, int N, int M, int end_slack, float gu, float gl, float* __restrict__ cost,
          int8_t* __restrict__ ptr) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = nn[b], m = mm[b];
  if (n <= 0 || m <= 0) return;
  const int bw = max(band[b], end_slack + 8);
  const float* e = ev + (size_t)b * N;
  const float* l = lvl + (size_t)b * M;
  float* C = cost + (size_t)b * N * M;
  int8_t* P = ptr + (size_t)b * N * M;
  const int row0 = min(min(m, bw + 1), end_slack);
  for (int j = 0; j < row0; ++j) C[j] = fabsf(e[0] - l[j]);
  for (int i = 1; i < n; ++i) {
    const int c = (int)(((int64_t)i * m) / n);
    const int jlo = max(0, c - bw), jhi = min(m, c + bw + 1);
    const float* up_row = C + (size_t)(i - 1) * M;
    float* row = C + (size_t)i * M;
    int8_t* prow = P + (size_t)i * M;
    const float ei = e[i];
    float prev_left = kBigF;
    for (int jj = jlo; jj < jhi; ++jj) {
      const float d = jj > 0 ? up_row[jj - 1] : (i > end_slack ? kBigF : 0.f);
      const float u = up_row[jj] + gu;
      const float le = prev_left + gl;
      float best = d;
      int8_t p = 0;
      if (u < best) {
        best = u;
        p = 1;
      }
      if (le < best) {
        best = le;
        p = 2;
      }
      const float v = fabsf(ei - l[jj]) + best;
      row[jj] = v;
      prow[jj] = p;
      prev_left = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
banded_path(const float* __restrict__ cost, const int8_t* __restrict__ ptr,
            const int* __restrict__ nn, const int* __restrict__ mm, int B, int N, int M,
            int end_slack, int* __restrict__ end_i, int* __restrict__ end_j,
            int* __restrict__ px, int* __restrict__ py, int* __restrict__ plen) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = nn[b], m = mm[b];
  if (n <= 0 || m <= 0) {
    end_i[b] = -1;
    end_j[b] = -1;
    plen[b] = 0;
    return;
  }
  const float* C = cost + (size_t)b * N * M;
  const int8_t* P = ptr + (size_t)b * N * M;
  int i = n - 1, j = max(0, m - end_slack);
  float best = C[(size_t)i * M + j];
  for (int jj = j + 1; jj < m; ++jj) {
    const float v = C[(size_t)(n - 1) * M + jj];
    if (v < best) {
      best = v;
      j = jj;
    }
  }
  for (int ii = max(0, n - end_slack); ii < n; ++ii) {
    const float v = C[(size_t)ii * M + m - 1];
    if (v < best) {
      best = v;
      i = ii;
      j = m - 1;
    }
  }
  end_i[b] = i;
  end_j[b] = j;
  int* ox = px + (size_t)b * (N + M);
  int* oy = py + (size_t)b * (N + M);
  int k = 0;
  while (true) {
    ox[k] = i;
    oy[k] = j;
    ++k;
    if (i == 0) break;
    const int8_t p = P[(size_t)i * M + j];
    if (p == 0) {
      --i;
      if (j > 0) --j;
    } else if (p == 1) {
      --i;
    } else {
      --j;
    }
  }
  plen[b] = k;
}

}  // namespace

// C entries, bound with ctypes. ev (B, N) and lvl (B, M) f32, n, m and
// band (B,) i32 on the card; cost (B*N*M f32, BIGF) and ptr (B*N*M i8, 0)
// filled by the caller. Each launches on `stream`, allocates nothing and
// returns cudaGetLastError() (0 on success).
extern "C" int sf_banded_dtw(const float* ev, const float* lvl, const int* n, const int* m,
                             const int* band, int B, int N, int M, int end_slack, float gu,
                             float gl, float* cost, int8_t* ptr, void* stream) {
  if (B < 0 || N < 1 || M < 1 || end_slack < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  banded_dp<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      ev, lvl, n, m, band, B, N, M, end_slack, gu, gl, cost, ptr);
  return (int)cudaGetLastError();
}

// end_i, end_j (B,) i32, px and py (B, N + M) i32 in walk order, plen
// (B,) i32.
extern "C" int sf_banded_path(const float* cost, const int8_t* ptr, const int* n, const int* m,
                              int B, int N, int M, int end_slack, int* end_i, int* end_j,
                              int* px, int* py, int* plen, void* stream) {
  if (B < 0 || N < 1 || M < 1 || end_slack < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  banded_path<<<(B + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      cost, ptr, n, m, B, N, M, end_slack, end_i, end_j, px, py, plen);
  return (int)cudaGetLastError();
}
