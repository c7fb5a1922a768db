// The pore-model trainer's gap-penalised subsequence DTW, batched, for
// Hopper (sm_90a).
//
// Replaces the numpy host code sigfish_tpu/models/train_model.py::
// _subsequence_cost_gap (:168) and _backtrack_gap (:206), as _dtw_pairs
// runs them in each EM iteration's E-step (ops/train_dtw.py has the
// wrapper and the plain PyTorch version). Case b's rows x[b, :n] are the
// dwell-expanded k-mer levels, its columns y[b, :m] the read's events.
//
// The JAX function computes each column j >= 1 from the previous one, P,
// by the prefix-min identity, every line numpy's f32 expression:
//   s_i   = s_{i-1} + |x_i - y_j|,            s_0 = |x_0 - y_j|
//   t_i   = (min(P_i + gl, P_{i-1}) - s_{i-1}) - iu_i,   t_0 = 0
//   h_i   = min(h_{i-1}, t_i)
//   col_i = (s_i + iu_i) + h_i,               col_0 = |x_0 - y_j|
// with iu_i = f32(f64(i) * f64(gu)), and the first column
// acc_i = acc_{i-1} + (|x_i - y_0| + gu), col_i = acc_i - gu. s and h run
// down the column in the order numpy's float32 cumsum and
// minimum.accumulate take, so cell (i, j) needs only (i-1, j), (i, j-1)
// and (i-1, j-1): an anti-diagonal wavefront computes it bit for bit.
//
// A block of W warps a case (W = 1 to 4, the wrapper's pick), in one
// launch: the sweep, the end and the walk.
//
//   sweep  R = 8 rows a lane, 32R = 256 rows a stripe, stripe k to warp
//          k mod W, the stripes aligned so the last one ends at row n - 1
//          (the first may start above row 0: those rows, all of a case
//          shorter than a stripe but its last n, compute nothing that row
//          0 reads). A warp steps
//          over the columns with a lag of one step a lane: at step t lane
//          l holds column t - l, its R cells in order down the column, s,
//          h and the previous column's costs in registers. The s, h, col
//          at j and col at j - 1 of the row above the lane's first come
//          from lane l - 1 by four shuffles; lane 0 reads them from shared
//          memory, where lane 31 of the stripe above wrote its last row
//          (W + 1 row buffers, stripe k's at k mod (W + 1): the warp that
//          reuses one is the warp that read it). The stripes run as a
//          pipeline: lane 31 publishes how far its row is written every 32
//          steps (a counter in shared memory, after a fence), and the next
//          stripe's warp waits on it once every 32 steps. Every per-step
//          access is unconditional, every lane loading or storing (to its
//          idle slots where it has nothing to store): a branch that only
//          some lanes take costs the warp more than the access.
//   walk   at (i, j), i, j >= 1, the lane already holds the three values
//          _backtrack_gap compares: up = col_{i-1,j} + gu, diag = P_{i-1},
//          left = P_i + gl. It stores the choice in 2 bits (0 diag if it
//          is the minimum, else 1 left if it is, else 2 up): a lane's R
//          choices are one 16-bit word a step, 4 steps' words one 8-byte
//          pack, 32 lanes' packs one coalesced store (a store a
//          step costs the warp more than its cells). Lane 31 of the last
//          stripe holds row n - 1 and keeps its first argmin over the
//          columns (strict <): the end and its cost.
//          Warp 0 then walks in step from (n - 1, end) to row 0 (column 0
//          is always up), holding 32 columns' words of one lane's run, one
//          a lane, and those of the run above, reading a move with one
//          shuffle; the path leaves 32 entries at a time, then -1 to N + M.
//          No cost matrix exists.
//
// What bounds it: a case is ceil(n / 32R) stripes of m + 31 steps, each
// step R cells of ~20 issued instructions behind four shuffles and the
// step's loads and stores, ~420 SM cycles a step on one warp at R = 8
// (chip_smoke.py phase 12 and scripts/bench_train_dtw.py measure it), a
// dependent chain far from the issue rate; a case's warps hold few of an
// SM's four schedulers. Bytes (inputs, 2 bits a cell of choices, the
// path) are tens of MB at most. The design puts R rows on a lane so the
// shuffles and the loop pay once for R cells, keeps every value out of
// device memory but the choices, and runs W stripes of a case at once on
// W warps, which share the schedulers and hide each other's latency (at
// 3 warps ~205 cycles a case's step).
// Build with -fmad=false and without --use_fast_math: every value is held
// bit for bit to the plain version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kSlots = kMaxWarps + 1;  // row buffers, and their counters
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDone = 0x7fffffff;  // a counter's column part: the row is whole
constexpr int R = 8;                // rows a lane
using W = uint16_t;                 // a lane's R choices a step, 2 bits a row
constexpr int kPack = 8 / sizeof(W), kBits = 8 * sizeof(W);  // words a pack

// profiling, where the caller passes `clocks` (else NULL): thread 0 writes
// its case's SM and the SM clock at the start, after the sweep and after
// the walk, 4 values a case
__device__ __forceinline__ long long sm_id() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// a row counter's value: stripe k has written its last row below column col
__device__ __forceinline__ long long progress(int k, int col) {
  return ((long long)k << 32) | (unsigned)col;
}

struct Case {
  const float* x;
  const float* y;  // the case's columns, copied to shared memory
  float* idle;     // this thread's 3 idle slots, istride apart
  int istride, n, m, M, top;
  float gu, gl;
};

// one stripe of the sweep; FIRST: stripe 0, holding row 0 (and the rows
// above it, which stand in for nothing). above / theirs: the stripe above's
// last row and its counter; mine / ours this stripe's. Lane 31 of the last
// stripe keeps the last row's first argmin in best, bj.
template <bool FIRST>
__device__ __forceinline__ void sweep_stripe(const Case& c, int k, bool last, int lane,
                                             const float* above, volatile long long* theirs,
                                             float* mine, volatile long long* ours,
                                             uint64_t* packs, float& best, int& bj) {
  const int ib = c.top + k * 32 * R + lane * R;  // the lane's first row
  float xr[R], iur[R], P[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = ib + r;
    xr[r] = i >= 0 ? c.x[i] : 0.f;
    iur[r] = (float)((double)max(i, 0) * (double)c.gu);
    P[r] = 0.f;
  }
  const int M = c.M, m = c.m;
  const int T = (m + 31 + kPack - 1) / kPack * kPack;  // past m + 31 every lane is past m
  long long seen = 0;
  // wait until the row above is written below column col (warp-uniform)
  auto wait_above = [&](int col) {
    if (FIRST) return;
    const long long need = progress(k - 1, min(col, m));
    if (seen >= need) return;
    do {
      seen = __shfl_sync(kFull, *theirs, 0);
    } while (seen < need);
    __threadfence_block();
  };
  // the lane's last row: s, h and col at its last column, col before it
  float s_last = 0.f, h_last = 0.f, c_last = 0.f, cp_last = 0.f;
  // lane 0: the row above's s, h and col at its column (read a step ahead)
  // and its col at the column before
  wait_above(33);
  float sN = FIRST ? 0.f : above[0], hN = FIRST ? 0.f : above[M];
  float cN = FIRST ? 0.f : above[2 * M], a_prev = 0.f;
  // one step, its word returned; COL0: the first chunk's, where lane l
  // meets column 0 at step l (no later step has a lane there)
  auto step = [&](int t, auto col0) -> W {
    const int j = t - lane;
    float sA = __shfl_up_sync(kFull, s_last, 1);
    float hA = __shfl_up_sync(kFull, h_last, 1);
    float cA = __shfl_up_sync(kFull, c_last, 1);
    float dA = __shfl_up_sync(kFull, cp_last, 1);
    if (lane == 0) {  // selects: no lane branches
      sA = sN;
      hA = hN;
      cA = cN;
      dA = a_prev;
    }
    a_prev = cA;
    if (!FIRST) {
      const int jn = min(max(j + 1, 0), m - 1);
      sN = above[jn];
      hN = above[M + jn];
      cN = above[2 * M + jn];
    }
    const float yj = c.y[min(max(j, 0), m - 1)];
    // columns outside [0, m) compute values nothing reads: a lane's
    // registers before its column 0 are replaced there, and after its
    // last column the lane below has taken what it needs
    W word = 0;
    if (decltype(col0)::value && j == 0) {
      float acc = sA;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float loc = fabsf(xr[r] - yj) + c.gu;
        acc = (FIRST && ib + r <= 0) ? loc : acc + loc;
        P[r] = acc - c.gu;
      }
      s_last = acc;
      h_last = 0.f;
      cp_last = 0.f;
    } else {
      float sP = sA, hP = hA, cP = cA, dP = dA;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float loc = fabsf(xr[r] - yj);
        const float Pi = P[r];
        const float lf = Pi + c.gl;
        const float tt = (fminf(lf, dP) - sP) - iur[r];
        float h = fminf(hP, tt);
        float s = sP + loc;
        float col = (s + iur[r]) + h;
        if (FIRST) {  // row 0, the free start (and the rows above it), by selects
          const bool z = ib + r <= 0;
          s = z ? loc : s;
          h = z ? 0.f : h;
          col = z ? loc : col;
        }
        // the walk's choice at (i, j); a row 0 choice is never read
        // (diag the minimum of the three, else left if it is: compares
        // that give the same choice as the equalities with their minimum)
        const float up = cP + c.gu;
        const bool diag = dP <= up && dP <= lf;
        const unsigned ch = diag ? 0u : (lf <= up ? 1u : 2u);
        word |= (W)(ch << (2 * r));
        dP = Pi;
        P[r] = col;
        sP = s;
        hP = h;
        cP = col;
      }
      s_last = sP;
      h_last = hP;
      cp_last = dP;
    }
    c_last = P[R - 1];
    // lane 31: the last stripe's first argmin of row n - 1, or the row the
    // next stripe's lane 0 reads
    const bool own = lane == 31 && j >= 0 && j < m;
    const bool better = own && last && c_last < best;
    best = better ? c_last : best;
    bj = better ? j : bj;
    const bool hand = own && !last;
    float* dst = hand ? mine + j : c.idle;
    const int stride = hand ? M : c.istride;
    dst[0] = s_last;
    dst[stride] = h_last;
    dst[2 * stride] = c_last;
    return word;
  };
  // 32 steps a chunk: the waits and the counter between chunks, nothing
  // but the cells inside one; a lane's words leave P steps at a time, as
  // one 8-byte pack (a store a step would cost the warp more than the step)
  auto chunk = [&](int t0, int tn, auto col0) {
    for (int u = t0; u < t0 + tn; u += kPack) {
      uint64_t pack = 0;
#pragma unroll
      for (int q = 0; q < kPack; ++q) pack |= (uint64_t)step(u + q, col0) << (q * kBits);
      packs[(size_t)(u / kPack) * 32 + lane] = pack;
    }
  };
  for (int t0 = 0; t0 < T; t0 += 32) {
    wait_above(t0 + 33);
    const int tn = min(32, T - t0);
    if (t0 == 0)
      chunk(t0, tn, Flag<true>());
    else
      chunk(t0, tn, Flag<false>());
    if (!last && lane == 31) {  // the row is written below column t0 + tn - 31
      __threadfence_block();
      *ours = progress(k, t0 + tn == T ? kDone : max(t0 + tn - 31, 0));
    }
  }
}

__global__ void __launch_bounds__(32 * kMaxWarps)
gap_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const int* __restrict__ nn, const int* __restrict__ mm, int N, int M, float gu,
           float gl, int64_t case_words, uint64_t* __restrict__ words,
           int buf_floats, float* __restrict__ scratch, int* __restrict__ end,
           float* __restrict__ end_cost, int* __restrict__ px, int* __restrict__ py,
           int* __restrict__ plen, long long* __restrict__ clocks) {
  extern __shared__ float smem[];
  __shared__ long long written[kSlots];
  __shared__ float end_best;
  __shared__ int end_col;
  constexpr int H = 32 * R;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int n = nn[b], m = mm[b];
  int* ox = px + (size_t)b * (N + M);
  int* oy = py + (size_t)b * (N + M);
  if (n <= 0 || m <= 0 || n > N || m > M) {  // empty, or lengths past the padding
    if (threadIdx.x == 0) {
      end[b] = -1;
      end_cost[b] = n >= 0 && m >= 0 && n <= N && m <= M ? 0.f : NAN;
      plen[b] = 0;
    }
    for (int k = threadIdx.x; k < N + M; k += blockDim.x) ox[k] = oy[k] = -1;
    return;
  }
  if (clocks && threadIdx.x == 0) {
    clocks[4 * b] = sm_id();
    clocks[4 * b + 1] = clock64();
  }
  const int K = (n + H - 1) / H;
  const int slots = nw + 1;
  // shared memory (or this case's scratch where it does not fit): the
  // case's columns, `slots` stripes' last rows (s, h and col over the
  // columns) and 3 idle slots a thread
  float* buf = scratch ? scratch + (size_t)b * buf_floats : smem;
  for (int k = threadIdx.x; k < m; k += blockDim.x) buf[k] = y[(size_t)b * M + k];
  if (threadIdx.x < kSlots) written[threadIdx.x] = 0;
  float* rows = buf + M;
  const Case c{x + (size_t)b * N, buf, rows + slots * 3 * M + threadIdx.x, (int)blockDim.x,
               n, m, M, n - K * H, gu, gl};
  uint64_t* C = words + (size_t)b * case_words;
  const size_t stripe_packs = (size_t)((M + 31 + kPack - 1) / kPack) * 32;
  float best = INFINITY;
  int bj = 0;
  __syncthreads();
  for (int k = warp; k < K; k += nw) {
    const float* above = rows + ((k + slots - 1) % slots) * 3 * M;
    float* mine = rows + (k % slots) * 3 * M;
    volatile long long* theirs = written + (k + slots - 1) % slots;
    volatile long long* ours = written + k % slots;
    if (k == 0)
      sweep_stripe<true>(c, k, K == 1, lane, above, theirs, mine, ours, C, best, bj);
    else
      sweep_stripe<false>(c, k, k == K - 1, lane, above, theirs, mine, ours,
                             C + k * stripe_packs, best, bj);
  }
  if (warp == (K - 1) % nw && lane == 31) {
    end_best = best;
    end_col = bj;
  }
  __syncthreads();  // every stripe swept: the end and the choices whole
  if (warp > 0) return;
  if (clocks && lane == 0) clocks[4 * b + 2] = clock64();
  best = end_best;
  bj = end_col;
  if (lane == 0) {
    end[b] = bj;
    end_cost[b] = best;
  }

  // the walk, warp 0 in step. It holds the choice words of one lane's run
  // (stripe tk, lane tl) at columns jt - 31 .. jt, column jt - k in lane
  // k, and those of the run above at the same columns, loaded with them:
  // the walk goes up from run to run, and a window's 32 columns last ~20
  // moves
  int i = n - 1, j = bj, q = 0, keep_i = 0, keep_j = 0;
  int tk = -1, tl = -1, jt = 0;
  W w = 0, wu = 0;
  auto word_at = [&](int ks, int ll, int col) -> W {
    const int t = col + ll;  // the step of column col in lane ll's run
    return ks >= 0 && col >= 0
               ? (W)(C[ks * stripe_packs + (size_t)(t / kPack) * 32 + ll] >> (t % kPack * kBits))
               : (W)0;
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
      if (j == 0) {
        --i;
        continue;
      }
      const unsigned rr = i - c.top;  // >= 0: unsigned, so the divisions are shifts
      const int ks = rr / H, ll = rr % H / R, r = rr % R;
      const bool in = j <= jt && j >= jt - 31;
      if (!(in && ks == tk && ll == tl)) {
        const bool up = in && (tl > 0 ? ks == tk && ll == tl - 1 : ks == tk - 1 && ll == 31);
        if (up) {
          w = wu;
        } else {
          jt = j;
          w = word_at(ks, ll, jt - lane);
        }
        tk = ks;
        tl = ll;
        wu = ll > 0 ? word_at(ks, ll - 1, jt - lane) : word_at(ks - 1, 31, jt - lane);
      }
      const int ch = (__shfl_sync(kFull, (unsigned)w, jt - j) >> (2 * r)) & 3;
      // 0 diagonal, 1 left, 2 up, by arithmetic
      i -= ch != 1;
      j -= ch != 2;
    }
    if (lane < u) {
      ox[q + lane] = keep_i;
      oy[q + lane] = keep_j;
    }
    q += u;
  }
  for (int k = q + lane; k < N + M; k += 32) ox[k] = oy[k] = -1;
  if (lane == 0) plen[b] = q;
  if (clocks && lane == 0) clocks[4 * b + 3] = clock64();
}

}  // namespace

// C entry, bound with ctypes. x (B, N) and y (B, M) f32, n and m (B,) i32
// on the card (a case with n outside [0, N] or m outside [0, M] gets end
// -1, end cost NaN and no path); warps 1 to 4 a case; words holds B *
// case_words 8-byte packs of choice words (4 u16 words a pack), a case's
// stripes ceil((M + 31) / 4) * 32 packs apart, case_words >= ceil(N / 256)
// stripes of them; buf_floats = M + (warps + 1) * 3 * M + 96 * warps;
// scratch NULL (the buffers in shared memory) or B * buf_floats f32.
// Outputs: end (B,) i32, end_cost (B,) f32, px and py (B, N + M) i32 in
// walk order padded with -1, plen (B,) i32; clocks NULL or B * 4 i64
// (sm_id). Launches on `stream`, allocates nothing and returns
// cudaGetLastError() (0 on success).
extern "C" int sf_gap_dtw(const float* x, const float* y, const int* n, const int* m, int B,
                          int N, int M, float gu, float gl, int warps, long long case_words,
                          void* words, int buf_floats, float* scratch, int* end,
                          float* end_cost, int* px, int* py, int* plen, long long* clocks,
                          void* stream) {
  if (B < 0 || N < 1 || M < 1 || case_words < 1 || warps < 1 || warps > kMaxWarps ||
      buf_floats < M + (warps + 1) * 3 * M + 96 * warps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = scratch ? 0 : (size_t)buf_floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(gap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gap_kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(
      x, y, n, m, N, M, gu, gl, case_words, (uint64_t*)words, buf_floats, scratch, end, end_cost,
      px, py, plen, clocks);
  return (int)cudaGetLastError();
}
