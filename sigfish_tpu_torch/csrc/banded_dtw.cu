// The pore-model trainer's banded, end-anchored DTW, batched, for Hopper
// (sm_90a).
//
// Replaces the numpy host code sigfish_tpu/models/train_model.py::
// _banded_anchored_dtw (:419), which fit_model_banded runs for every read
// in each EM iteration's E-step (ops/train_dtw.py has the wrapper and the
// plain PyTorch version). Case b's rows ev[b, :n] are the read's events,
// its columns lvl[b, :m] the dwell-expanded levels. Row i's band is
// jlo(i) = max(0, c - bw) .. jhi(i) = min(m, c + bw + 1), c = (i*m)//n,
// bw = max(band, end_slack + 8); every cell outside it holds BIGF = 3e37
// and a diagonal pointer in the JAX function, and reads so here.
//
// A block of W warps a case (W = 1 to 4, the wrapper's pick), in one
// launch: the sweep, the end cell and the walk.
//
//   sweep  rows go to lanes in stripes of 32 (lane l owns row 32g + l),
//          stripe g to warp g mod W. A warp steps over its stripe's
//          columns, jlo of its first row to jhi of its last, with a lag
//          of one step a lane, so a step is an anti-diagonal: at step t
//          lane l holds column jlo(32g) + t - l. Cell (i-1, j) comes from
//          lane l-1 by one shuffle, cell (i-1, j-1) is the one it passed
//          the step before, the left cell stays in the lane's register.
//          Lane 0 reads its row above, stripe g-1's last row, from shared
//          memory (W + 1 row buffers, stripe g's at g mod (W + 1): the warp
//          that reuses one is the warp that read it); lane 31's cells come
//          to lane u by a shuffle at step u of each 32-step chunk, and the
//          chunk's 32 leave as one store. The stripes run as a pipeline:
//          after each chunk lane 31 publishes how far its row is written (a
//          counter in shared memory, after a fence), and the next stripe's
//          warp waits on it before each chunk. Each cell as the JAX loop
//          has it: the diagonal first (at column 0: 0 while i <=
//          end_slack, else BIGF), then up + gap_up only if strictly less,
//          then left + gap_left only if strictly less, plus |ev_i - lvl_j|,
//          each an f32 add; row 0 is |ev_0 - lvl_j| for j < end_slack
//          within its band. Inside a chunk every access is unconditional
//          and every lane's (the end candidates' stores behind a
//          warp-uniform test): a branch that only some lanes take, or a
//          store a step, costs the warp more than the cell.
//   ptrs   a step's 32 pointers leave as two ballots (up, left), 8 bytes
//          a step, stored 32 steps at a time by the warp: the stripe's
//          steps in order, a stripe at g * S of the case's words. No cost
//          matrix exists: only the end candidates are kept (the last row's
//          last end_slack columns, the last column's last end_slack rows,
//          in shared memory), and the first minimum in that list order
//          (strict <) is the end cell.
//   walk   warp 0 walks in step, from the end cell to row 0: a cell's
//          pointer is bit l of its stripe's words at step j - jlo(32g) + l
//          (0 outside the swept steps, as outside the band). A move lowers
//          the step by one or two, so the warp holds 32 consecutive steps'
//          words, one a lane, and the 32 below them, and reads a move with
//          two shuffles. The path leaves 32 entries at a time, coalesced,
//          then -1 to N + M.
//
// What bounds it: each case is n / 32 stripes of about 2 * bw + 32 m / n
// + 31 steps, a step a dependent chain of two shuffles, two ballots and
// a compare-select-add, which one warp runs at ~300 SM cycles a step
// (chip_smoke.py phase 12 and scripts/bench_train_dtw.py measure it):
// far under the issue rate, and the bytes (inputs, 8 bytes a step of
// pointers, the path) are a few MB. So the chain's latency sets the
// time. The design keeps the chain in registers and shuffles, with no
// round trip to memory a cell, and runs W stripes of a case at once on W
// warps, which share an SM's schedulers and hide each other's latency
// (~150-170 cycles a case's step at 2 to 3).
// Build with -fmad=false and without --use_fast_math: every value is held
// bit for bit to the plain version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kSlots = kMaxWarps + 1;  // row buffers, and their counters
constexpr float kBigF = 3e37f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDone = 0x7fffffff;  // a counter's column part: the row is whole

// profiling, where the caller passes `clocks` (else NULL): thread 0 writes
// its case's SM and the SM clock at the start, after the sweep and after
// the walk, 4 values a case
__device__ __forceinline__ long long sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

struct Band {
  int n, m, bw;
  __device__ int c(int i) const { return (int)(((int64_t)i * m) / n); }
  __device__ int lo(int i) const { return max(0, c(i) - bw); }
  __device__ int hi(int i) const { return min(m, c(i) + bw + 1); }
};

// steps a stripe may take: its columns span at most 2*bw + 2 + 31*m/n (and
// m), plus the 31 of the lag. The wrapper sizes the pointer words by it.
__device__ __forceinline__ int stripe_stride(int n, int m, int bw) {
  return (int)min((int64_t)m, 2 * (int64_t)bw + 2 + (31 * (int64_t)m) / n) + 31;
}

// a row counter's value: stripe g has written its last row below column col
__device__ __forceinline__ long long progress(int g, int col) {
  return ((long long)g << 32) | (unsigned)col;
}

__global__ void __launch_bounds__(32 * kMaxWarps)
banded_kernel(const float* __restrict__ ev, const float* __restrict__ lvl,
              const int* __restrict__ nn, const int* __restrict__ mm,
              const int* __restrict__ band, int N, int M, int end_slack, float gu, float gl,
              int64_t case_words, uint2* __restrict__ words, int row_cap, int smem_floats,
              float* __restrict__ scratch, int* __restrict__ end_i, int* __restrict__ end_j,
              int* __restrict__ px, int* __restrict__ py, int* __restrict__ plen,
              long long* __restrict__ clocks) {
  extern __shared__ float smem[];
  __shared__ long long written[kSlots];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int n = nn[b], m = mm[b];
  int* ox = px + (size_t)b * (N + M);
  int* oy = py + (size_t)b * (N + M);
  if (n <= 0 || m <= 0) {
    if (threadIdx.x == 0) {
      end_i[b] = -1;
      end_j[b] = -1;
      plen[b] = 0;
    }
    for (int k = threadIdx.x; k < N + M; k += blockDim.x) ox[k] = oy[k] = -1;
    return;
  }
  if (clocks && threadIdx.x == 0) {
    clocks[4 * b] = sm_id();
    clocks[4 * b + 1] = clock64();
  }
  const Band bd{n, m, max(band[b], end_slack + 8)};
  const float* e = ev + (size_t)b * N;
  uint2* W = words + (size_t)b * case_words;
  const int S = stripe_stride(n, m, bd.bw);
  const int slots = nw + 1;
  // shared memory (or this case's scratch where it does not fit): the
  // case's levels, `slots` rows of row_cap floats and the end candidates
  // (last row, then last column)
  float* buf = scratch ? scratch + (size_t)b * smem_floats : smem;
  float* lrow = buf;
  const int c0 = max(0, m - end_slack), nr = m - c0;   // last row's candidates
  const int r0 = max(0, n - end_slack), nc = n - r0;   // last column's
  float* cand = buf + M + slots * row_cap;
  for (int k = threadIdx.x; k < m; k += blockDim.x) lrow[k] = lvl[(size_t)b * M + k];
  for (int k = threadIdx.x; k < nr + nc; k += blockDim.x) cand[k] = kBigF;
  if (threadIdx.x < kSlots) written[threadIdx.x] = 0;
  const int row0_end = min(end_slack, m);
  __syncthreads();

  const int G = (n + 31) / 32;
  for (int g = warp; g < G; g += nw) {
    const int i0 = 32 * g;
    const int i = i0 + lane;
    const bool live = i < n;
    const int J0 = bd.lo(i0);
    const int T = bd.hi(min(n - 1, i0 + 31)) - J0 + 31;
    const int jlo = live ? bd.lo(i) : 0, jhi = live ? bd.hi(i) : 0;
    const float ei = live ? e[i] : 0.f;
    // lane 0's row above: stripe g - 1's last row over its band
    const float* above = buf + M + ((g + slots - 1) % slots) * row_cap;
    const int alo = g > 0 ? bd.lo(i0 - 1) : 0, ahi = g > 0 ? bd.hi(i0 - 1) : 0;
    float* mine = buf + M + (g % slots) * row_cap;
    volatile long long* theirs = written + (g + slots - 1) % slots;
    volatile long long* ours = written + g % slots;
    long long seen = 0;
    // wait until the row above is written below column col (warp-uniform)
    auto wait_above = [&](int col) {
      if (g == 0) return;
      const long long need = progress(g - 1, min(col, ahi));
      if (seen >= need) return;
      do {
        seen = __shfl_sync(kFull, *theirs, 0);
      } while (seen < need);
      __threadfence_block();
    };
    auto above_at = [&](int j) {  // every lane reads; lane 0's value counts
      const float a = above[min(max(j - alo, 0), row_cap - 1)];
      return j >= alo && j < ahi ? a : kBigF;
    };
    // the lane's cell (i, j - 1) and the cell (i - 1, j - 1) it was passed;
    // lane 0 reads its row above a step ahead
    wait_above(J0 + 33);
    float cur = kBigF;
    float last_up = lane == 0 ? above_at(J0 - 1) : kBigF;
    float up_next = above_at(J0);
    int j = J0 - lane;
    unsigned keep_up = 0, keep_left = 0;
    // 32 steps a chunk: the waits, the pointer words' stores and the
    // counter between chunks, nothing but the cells inside one
    // lane 31's band: its row is the one the next stripe reads
    const int jlo31 = __shfl_sync(kFull, jlo, 31), jhi31 = __shfl_sync(kFull, jhi, 31);
    for (int t0 = 0; t0 < T; t0 += 32) {
      wait_above(J0 + t0 + 33);
      const int tn = min(32, T - t0);
      float keep_row = kBigF;  // lane 31's cell at step t0 + lane
      for (int u = 0; u < tn; ++u, ++j) {
        const float lv = lrow[min(max(j, 0), m - 1)];
        const float from = __shfl_up_sync(kFull, cur, 1);
        const float up = lane == 0 ? up_next : from;
        up_next = above_at(j + 1);
        const float diag = last_up;
        last_up = up;
        // the cell by selects, kept only within the row's band
        const float loc = fabsf(ei - lv);
        const float d = j > 0 ? diag : (i > end_slack ? kBigF : 0.f);
        const float u_ = up + gu;
        const float le = cur + gl;
        const bool take_u = u_ < d;
        float best = take_u ? u_ : d;
        const bool take_le = le < best;
        best = take_le ? le : best;
        float v = loc + best;
        if (i == 0) v = j < row0_end ? loc : kBigF;
        const bool inb = j >= jlo && j < jhi;
        const int p = !inb || i == 0 ? 0 : (take_le ? 2 : (take_u ? 1 : 0));
        cur = inb ? v : kBigF;
        const float v31 = __shfl_sync(kFull, v, 31);
        keep_row = lane == u ? v31 : keep_row;
        // the end candidates, where this step can hold one (a warp-uniform
        // test: lane 0 is at column J0 + t0 + u, lane 31 31 columns left)
        const int j0 = J0 + t0 + u;
        if (g == G - 1 || (j0 >= m - 1 && j0 - 31 <= m - 1)) {
          if (inb && i == n - 1 && j >= c0) cand[j - c0] = v;
          if (inb && j == m - 1 && i >= r0) cand[nr + i - r0] = v;
        }
        const unsigned bu = __ballot_sync(kFull, p == 1), bl = __ballot_sync(kFull, p == 2);
        keep_up = lane == u ? bu : keep_up;
        keep_left = lane == u ? bl : keep_left;
      }
      if (lane < tn) W[(size_t)g * S + t0 + lane] = make_uint2(keep_up, keep_left);
      // lane 31's cells of the chunk, a lane each: column J0 + t0 + lane - 31
      const int col = J0 + t0 + lane - 31;
      if (lane < tn && col >= jlo31 && col < jhi31) mine[col - jlo31] = keep_row;
      __threadfence_block();
      __syncwarp();
      if (lane == 31)  // this stripe's last row is written below column j
        *ours = progress(g, t0 + tn == T ? kDone : max(j, 0));
    }
  }
  __syncthreads();  // every stripe swept: candidates and pointer words whole
  if (warp > 0) return;

  if (clocks && lane == 0) clocks[4 * b + 2] = clock64();
  // the end: the first minimum of the candidates in list order
  float best = INFINITY;
  int bi = n - 1, bj = c0;
  for (int k = 0; k < nr; ++k) {
    const float v = cand[k];
    if (v < best) {
      best = v;
      bj = c0 + k;
    }
  }
  for (int k = 0; k < nc; ++k) {
    const float v = cand[nr + k];
    if (v < best) {
      best = v;
      bi = r0 + k;
      bj = m - 1;
    }
  }
  if (lane == 0) {
    end_i[b] = bi;
    end_j[b] = bj;
  }

  // the walk, warp 0 in step. It holds 32 consecutive steps' words of the
  // stripe it is in, step tt - k in lane k, and the 32 steps below them,
  // loaded with them: a move lowers the step by one or two
  int i = bi, j = bj, k = 0, keep_i = 0, keep_j = 0;
  int tg = -1, tt = 0, J0 = 0, T = 0;
  uint2 w = make_uint2(0u, 0u), wn = w;
  auto word_at = [&](int g, int q) {
    return q >= 0 ? W[(size_t)g * S + q] : make_uint2(0u, 0u);
  };
  for (bool more = true; more;) {
    // 32 moves, then their cells leave as one store
    int u = 0;
    for (; u < 32; ++u) {
      keep_i = lane == u ? i : keep_i;
      keep_j = lane == u ? j : keep_j;
      if (i == 0) {
        more = false;
        ++u;
        break;
      }
      const int g = i >> 5, r = i & 31;
      if (g != tg) {
        tg = g;
        J0 = bd.lo(32 * g);
        T = bd.hi(min(n - 1, 32 * g + 31)) - J0 + 31;
        tt = -64;  // no words held
      }
      const int t = j - J0 + r;
      int up = 0, left = 0;
      if (t >= 0 && t < T) {
        if (t > tt || t < tt - 63) {
          tt = t;
          w = word_at(g, tt - lane);
          wn = word_at(g, tt - 32 - lane);
        } else if (t < tt - 31) {
          w = wn;
          tt -= 32;
          wn = word_at(g, tt - 32 - lane);
        }
        up = (__shfl_sync(kFull, w.x, tt - t) >> r) & 1;
        left = (__shfl_sync(kFull, w.y, tt - t) >> r) & 1;
      }
      // up, left, or the diagonal (which keeps column 0), by arithmetic
      i -= 1 - left;
      j -= left | (!up && j > 0);
    }
    if (lane < u) {
      ox[k + lane] = keep_i;
      oy[k + lane] = keep_j;
    }
    k += u;
  }
  for (int q = k + lane; q < N + M; q += 32) ox[q] = oy[q] = -1;
  if (lane == 0) plen[b] = k;
  if (clocks && lane == 0) clocks[4 * b + 3] = clock64();
}

}  // namespace

// C entry, bound with ctypes. ev (B, N) and lvl (B, M) f32, n, m and band
// (B,) i32 on the card; warps 1 to 4 a case; words holds B * case_words
// uint2 (each case's stripes at stripe_stride steps apiece); row_cap >=
// every row's band width; smem_floats = M + (warps + 1) * row_cap +
// min(end_slack, M) + min(end_slack, N); scratch NULL (the
// buffers in shared memory) or B * smem_floats f32. Outputs: end_i, end_j
// (B,) i32, px and py (B, N + M) i32 in walk order padded with -1, plen
// (B,) i32; clocks NULL or B * 4 i64 (sm_id). Launches on `stream`,
// allocates nothing and returns cudaGetLastError() (0 on success).
extern "C" int sf_banded_dtw(const float* ev, const float* lvl, const int* n, const int* m,
                             const int* band, int B, int N, int M, int end_slack, float gu,
                             float gl, int warps, long long case_words, void* words, int row_cap,
                             int smem_floats, float* scratch, int* end_i, int* end_j, int* px,
                             int* py, int* plen, long long* clocks, void* stream) {
  if (B < 0 || N < 1 || M < 1 || end_slack < 1 || row_cap < 1 || case_words < 1 || warps < 1 ||
      warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = scratch ? 0 : (size_t)smem_floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  banded_kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(
      ev, lvl, n, m, band, N, M, end_slack, gu, gl, (int64_t)case_words, (uint2*)words, row_cap,
      smem_floats, scratch, end_i, end_j, px, py, plen, clocks);
  return (int)cudaGetLastError();
}
