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
// The sum's order. The Q = 32 * ROWS rows are 32 contiguous runs of ROWS,
// one a lane. A run's sums are taken in row order (run[k] = run[k-1] +
// local[k]), and the runs are chained in lane order: E_0 = 0, E_{l+1} =
// E_l + T_l with T_l lane l's run total, s = run + E_l. The plain version
// sums in this order, so the two agree bit for bit (min is exact in any
// order). In it, s of the row above lane l's first row is T_{l-1} +
// E_{l-1} = E_l, the same bits, so t of a run's first row is
// min(c, c_above) - E_l.
//
// A lane-skewed pipeline, as csrc/wavefront.cu schedules its diagonals:
// lane l of a warp holds rows [l*ROWS, (l+1)*ROWS) and computes column
// j = j0 + t - l at step t. So what lane l needs of the rows above its
// run at column j, lane l - 1 made one step earlier, and one shuffle each
// brings it: E (the sum of all rows above), G (the minimum of all t above)
// and lane l - 1's last row of column j, which lane l keeps a step as its
// c_above for column j + 1. A step of a lane:
//   s[k] = run[k] + E;  t[0] = min(c[0], c_above) - E (lane 0: 0, or p0);
//   t[k] = min(c[k], c[k-1]) - s[k-1];  pm = min(G, t[0], ..., t[k]);
//   new[k] = s[k] + pm,
// and it hands on E + T (= s[ROWS-1], the same bits), pm of its last row
// and new[ROWS-1]. Lane 0 starts from E = 0 and G = +inf. No warp-wide
// scan is left: a lane's chain to the next lane is one shuffle, an add,
// a sub and its run's mins, and the run sums, which need only y, fill
// the wait for the shuffles. Each lane reads y and the reset flag of its
// own column a step ahead. The 31 steps of the pipeline's fill and drain
// run lanes outside the sweep: there a lane keeps its column (c = live ?
// new : c), stores nothing and clamps its loads, and what it hands on
// reaches only lanes outside the sweep; the steps in between carry no
// such select or clamp. The lane that holds row_b stores out[b, j] as it
// passes column j; the final column is each lane's rows after its last.
//
// A reset discards the carry: the lane adds +inf to its c and c_above for
// that column, an add on the FMA pipes where setting them to BIG takes a
// select on the ALU pipe, which the step's mins already load (6.6% of a
// Q=512 launch on an H100, scripts/bench_scan.py). The bits are BIG's:
// with c in [+0, BIG] the t of every row but row 0 is +inf here and BIG -
// s there, above row 0's t = 0 (std: p0 = 0), so the prefix min is 0 and
// new = s either way; the carry itself stays finite.
//
// A warp a (read, piece): a read's columns split at resets into up to K
// pieces (scan_kernel has the rule), each swept by its own warp. A reset
// discards the carry, so a piece that starts at one needs nothing of the
// columns before it, and the scores do not depend on K.
//
// Modes: one-shot (init null: the carry starts BIG) and carry (an
// initial (B, Q) column, taken by the piece at column 0); the final
// column goes to final_col when given, from the piece that ends at R, so
// segments chained through it equal one scan over their concatenation.
//
// What bounds it: B * Q * R cells at 9 f32 instructions each (the
// function's 8, and the add of a run's E), at the SMs' issue rate; the
// bytes are the (B, R) output. A warp's step is ROWS cells and some 50
// instructions more (shuffles, loads, the emitted row's pick and store;
// 111 a step at ROWS = 8, 181 at 16). At B = 512 over chip_smoke.py phase
// 7's 160 tracks, K = 4 pieces a read are four warps a scheduler and the
// issue rate sets the pace; phase 4's two tracks give two, and there a
// warp's chain of ROWS mins a step stalls it too.
// Build with -fmad=false and without --use_fast_math.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
// a read's pieces: about four warps a scheduler of the card's 132 SMs
// over the batch, and no piece's range under kMinPiece columns (a warp
// spends 31 steps of fill and drain on each)
constexpr int kTargetWarps = 2048;
constexpr int kMinPiece = 1024;

// The first reset column in [from, lim), lim if none: each of the warp's
// lanes reads one flag a ballot, four ballots a pass.
__device__ __forceinline__ int first_reset(const unsigned char* __restrict__ reset, int from,
                                           int lim, int lane) {
  for (int base = from; base < lim; base += 4 * 32) {
    bool f[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + 32 * u + lane;
      f[u] = j < lim && reset[j] != 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned m = __ballot_sync(kFull, f[u]);
      if (m) return base + 32 * u + __ffs((int)m) - 1;
    }
  }
  return lim;
}

// a[r] for this lane's r: a tree of selects on r's bits, ceil(log2(ROWS))
// predicates and ROWS - 1 selects
template <int ROWS>
__device__ __forceinline__ float pick_row(const float (&a)[ROWS], int r) {
  float v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) v[i] = a[i];
#pragma unroll
  for (int s = 1; s < ROWS; s <<= 1) {
#pragma unroll
    for (int i = 0; i + s < ROWS; i += 2 * s) v[i] = (r & s) ? v[i + s] : v[i];
  }
  return v[0];
}

// One lane's sweep over columns [j0, j0 + n) of one read: its rows' query
// values and carry, and what the pipeline hands from step to step.
template <int ROWS, bool STD>
struct Sweep {
  const float* ref;
  const unsigned char* reset;
  float* ob;        // out[b, :]
  int R, j0, n, lane, kk;
  bool store;       // this lane holds row_b (lane 0 where there is none)
  bool none;        // row_b < 0: the stored value is 0
  float x[ROWS], c[ROWS];
  float y1;         // y of this step's column, loaded the step before
  bool rs1;         // and its reset flag
  float ca = kBig;  // lane - 1's last row at this step's column - 1
  float e_out = 0.f, g_out = 0.f;

  __device__ __forceinline__ int col(int j) const { return min(max(j, 0), R - 1); }

  __device__ __forceinline__ void start() {
    y1 = ref[col(j0 - lane)];
    rs1 = reset[col(j0 - lane)] != 0;
  }

  // step t: column j0 + t - lane. GUARD: some lane lies outside the
  // sweep, or its next column outside [0, R) (the loads clamp)
  template <bool GUARD>
  __device__ __forceinline__ void step(int t) {
    const int j = j0 + t - lane;
    const float y = y1;
    const bool rs = rs1;
    const int jn = GUARD ? col(j + 1) : j + 1;
    y1 = ref[jn];
    rs1 = reset[jn] != 0;
    // the run sums: they need only y, so they fill the shuffles' wait
    float run[ROWS];
    run[0] = fabsf(x[0] - y);
#pragma unroll
    for (int k = 1; k < ROWS; ++k) run[k] = run[k - 1] + fabsf(x[k] - y);
    float e = __shfl_up_sync(kFull, e_out, 1);
    float g = __shfl_up_sync(kFull, g_out, 1);
    const float cl = __shfl_up_sync(kFull, c[ROWS - 1], 1);
    e = lane == 0 ? 0.f : e;
    g = lane == 0 ? INFINITY : g;
    const float p0 = STD && !rs ? c[0] : 0.f;
    // a reset: c and c_above + inf for this column (see the note at the top)
    float cc[ROWS], s[ROWS], nv[ROWS];
    const float f = rs ? INFINITY : 0.f;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      cc[k] = c[k] + f;
      s[k] = run[k] + e;
    }
    const float cu = ca + f;
    float pm = fminf(g, lane == 0 ? p0 : fminf(cc[0], cu) - e);
    nv[0] = s[0] + pm;
#pragma unroll
    for (int k = 1; k < ROWS; ++k) {
      pm = fminf(pm, fminf(cc[k], cc[k - 1]) - s[k - 1]);
      nv[k] = s[k] + pm;
    }
    e_out = s[ROWS - 1];
    g_out = pm;
    const bool live = !GUARD || (unsigned)(t - lane) < (unsigned)n;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) c[k] = live ? nv[k] : c[k];
    ca = cl;
    const float v = pick_row(nv, kk);
    if (store && live) ob[j] = none ? 0.f : v;
  }

  // the n + 31 steps: the fill and the drain guarded, the rest (every
  // lane in the sweep, and its next column too) not
  __device__ __forceinline__ void run_all() {
    if (n <= 0) return;
    start();
    const int steps = n + 31, hi = max(31, n - 1);
    int t = 0;
    for (; t < 31; ++t) step<true>(t);
    for (; t < hi; ++t) step<false>(t);
    for (; t < steps; ++t) step<true>(t);
  }
};

// Warp w sweeps piece p = w % K of read w / K: read-major, so at K = 4 a
// block is one read's pieces and every block carries the same columns.
// (The card places blocks on its SMs unevenly: piece-major, where a
// block's warps share one piece, piled up to three of phase 4's long
// warps on a scheduler, and read-major two; scripts/bench_scan.py
// --placement.) Piece p's range is [p*R/K, (p+1)*R/K); it starts at
// the first reset in its range (piece 0 at column 0) and ends where the
// next piece starts: at the first reset at or past the next range's
// start, or at R. A range with no reset is an empty piece, its columns
// swept by the piece before. A reset discards the carry (c = BIG and,
// with std, p0 = 0), so a piece started at one needs nothing of the
// columns before it: the scores are those of one sweep for every K.
template <int ROWS, bool STD>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    scan_kernel(const float* __restrict__ q, const int* __restrict__ lrow,
                const float* __restrict__ ref, const unsigned char* __restrict__ reset,
                const float* __restrict__ init, float* __restrict__ out,
                float* __restrict__ final_col, int B, int R, int K) {
  constexpr int Q = 32 * ROWS;
  const int lane = threadIdx.x & 31;
  const int wid = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (wid >= B * K) return;  // the whole warp
  const int b = wid / K, p = wid - b * K;
  const int a1 = (int)((long long)(p + 1) * R / K);
  const int j0 = p == 0 ? 0 : first_reset(reset, (int)((long long)p * R / K), a1, lane);
  if (p > 0 && j0 == a1) return;  // no reset in its range
  const int j1 = p == K - 1 ? R : first_reset(reset, a1, R, lane);
  const int base = lane * ROWS;
  const size_t qo = (size_t)b * Q + base;
  Sweep<ROWS, STD> w;
  w.ref = ref;
  w.reset = reset;
  w.ob = out + (size_t)b * R;
  w.R = R;
  w.j0 = j0;
  w.n = j1 - j0;
  w.lane = lane;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    w.x[k] = q[qo + k];
    w.c[k] = init && p == 0 ? init[qo + k] : kBig;
  }
  const int row = lrow[b];
  w.none = row < 0;
  w.store = row < 0 ? lane == 0 : (row >= base && row < base + ROWS);
  w.kk = row - base;
  w.run_all();
  if (final_col && j1 == R) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) final_col[qo + k] = w.c[k];
  }
}

template <int ROWS>
cudaError_t launch(const float* q, const int* lrow, const float* ref, const unsigned char* reset,
                   const float* init, float* out, float* final_col, int B, int R, int K,
                   bool std_, void* stream) {
  void (*kernel)(const float*, const int*, const float*, const unsigned char*, const float*,
                 float*, float*, int, int, int) =
      std_ ? scan_kernel<ROWS, true> : scan_kernel<ROWS, false>;
  const int grid = (int)(((long long)B * K + kWarpsPerBlock - 1) / kWarpsPerBlock);
  kernel<<<grid, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(q, lrow, ref, reset, init, out,
                                                                 final_col, B, R, K);
  return cudaGetLastError();
}

}  // namespace

// The pieces a read's R columns are split into at batch size B (B >= 1).
extern "C" int sf_sdtw_scan_pieces(int B, int R) {
  return max(1, min((kTargetWarps + B - 1) / B, R / kMinPiece));
}

// q (B, Q) f32, lrow (B,) i32 (the row to emit, -1 none), ref (R,) f32,
// reset (R,) u8, init (B, Q) f32 or null (BIG), out (B, R) f32, final_col
// (B, Q) f32 or null. Q = 32 * {1, 2, 4, 8, 12, 16}.
extern "C" int sf_sdtw_scan(const float* q, const int* lrow, const float* ref,
                            const unsigned char* reset, const float* init, float* out,
                            float* final_col, int B, int Q, int R, int std_, void* stream) {
  if (B < 0 || R < 0 || Q < 32 || Q % 32) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int K = sf_sdtw_scan_pieces(B, R);
#define SF_SCAN_LAUNCH(ROWS) \
  return (int)launch<ROWS>(q, lrow, ref, reset, init, out, final_col, B, R, K, std_, stream)
  switch (Q / 32) {
    case 1: SF_SCAN_LAUNCH(1);
    case 2: SF_SCAN_LAUNCH(2);
    case 4: SF_SCAN_LAUNCH(4);
    case 8: SF_SCAN_LAUNCH(8);
    case 12: SF_SCAN_LAUNCH(12);
    case 16: SF_SCAN_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SF_SCAN_LAUNCH
}
