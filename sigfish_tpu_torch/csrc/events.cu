// Batched event detection for `--host-stages device`: four launches from
// one C entry, the reads' sequential chains a thread a read, everything
// else across the card.
//
// Replaces the XLA device code of sigfish_tpu/ops/events_device.py
// (_detect_events_jit: _prefix_sums, _tstat, _detector_scan and the
// boundary gather), which has no Pallas kernel and no exact torch
// counterpart. The plain PyTorch version is
// sigfish_tpu_torch/ops/events_device.detect_peaks_plain; this kernel is
// held to it stage by stage, and to the host eventizer
// (ops/events.detect_events), bit for bit.
//
// Layout: the (S, B) i16 signal plane is time-major, so a warp's 32 lanes
// (32 reads) find a step's samples in 64 neighbouring bytes; the (S+1, B)
// f64 prefix planes A and Q and the (S, B) f32 t-stat planes likewise.
// The stages, in order on the caller's stream:
//   a. prefix   two threads a read (one in each warp of a block of 32
//               reads) walk its samples in order: pA = (raw + offset) *
//               raw_unit in f32, one A[i+1] = A[i] + (double)pA, the other
//               Q[i+1] = Q[i] + (double)(pA * pA) (the square rounded to
//               f32 before the f64 add, events.c:303-305), frozen past n;
//               they write the planes and A[n], Q[n]. A parallel scan
//               would reassociate the f64 adds, so the f64 add is the chain.
//   b. tstat    a thread a cell (i, b), over the whole (S, B) grid: the two
//               Welch t-stats of step i from A and Q at i - w, i, i + w
//               (events.c:319-368, the host compute_tstat's float/double
//               mixing op by op), 0 outside [w, n - w]; written to two
//               (S, B) f32 planes, t1 and t2 (8 bytes a cell: 256 MB at
//               the pipeline's 2^25-cell cap, beside the 0.5 GB of A and
//               Q), which the wrapper allocates.
//   c. detector a block of 3 warps over 32 reads walks steps 0..n-1: warp 0
//               the short detector over t1, warp 1 the long one over t2 a
//               tile behind, warp 2 the commits two tiles behind (the
//               coupled detector of events.c:375-447: the short one's peak
//               over its threshold resets the long one, and a step's short
//               commit comes before its long one); a commit with pos > 0
//               is appended to the read's peak slots, at most E of them,
//               past which its overflow flag is set; then its count.
//   d. gather   a thread a peak slot (b, k): A[pos], Q[pos] of each
//               committed peak; slots past the count get 0 (A[0] = 0).
//               A commit's plane loads would stall a warp on each step
//               where any of its lanes commits (a read commits every few
//               steps), so they leave the detector's chains.
// A batch is B/32 blocks (16 at B=512), so each SM sub-partition holds one
// chain warp, which pays the full latency of each dependent instruction: a
// step costs its whole body, not its recurrence. So the bodies are
// straight-line: stage a's inputs come from a shared ring that 16-byte
// cp.async fills three tiles ahead, its i16 converts on the integer and f32 pipes,
// and its stores are predicated, not branched around. Where a read has
// two chains they run in two warps of a block, each on its own
// sub-partition: stage a's A and Q sums share only their input; stage c's
// detectors (compares and selects, with a third warp appending their
// commits) share only the short detector's resets.
//
// The rings copy whole 16-byte chunks of a row, so B is a multiple of 8
// and the signal and t-stat planes start 16-byte aligned: the wrapper pads
// a batch with reads of 0 samples (ops/events_device.lane_width), and an
// entry given another B returns cudaErrorInvalidValue.
//
// Exactness: built with -fmad=false (no contraction of a multiply into an
// add), nvcc's default -prec-div=true, -prec-sqrt=true and -ftz=false. The
// f32 quotient combined_var / w is subnormal on near-flat windows; a
// flushed quotient would give |dm| / sqrt(0) = inf where the host has a
// huge finite t-stat, so nothing here flushes: plain `/`, sqrt() and
// fabs(), no __fdividef, rsqrt or fma.
//
// What bounds it on the card: bytes are 2 in and 16 out a sample (the
// f64 planes), a few ms at most at 3.35 TB/s; operations ~70 a sample,
// most of them stage b's f64 divisions and square roots, which run on
// every SM. Stages a and c remain dependent chains of S (or n) steps a
// read, so a launch is bound by them: the prefix by the f64 add's latency
// a step, the detector by its state's compares and selects a step.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stores under a predicate, without the branch (and its reconvergence)
// the compiler puts around a conditional store
__device__ __forceinline__ void st_if(double* p, double v, bool on) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q st.global.f64 [%0], %1;\n\t}"
               ::"l"(p), "d"(v), "r"((int)on) : "memory");
}

__device__ __forceinline__ void st_if(int32_t* p, int32_t v, bool on) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %2, 0;\n\t@q st.global.b32 [%0], %1;\n\t}"
               ::"l"(p), "r"(v), "r"((int)on) : "memory");
}

// (float)x of an i16 x, exactly, on the integer and f32 pipes: 1.5 * 2^23
// + x is a float whose low bits hold x (|x| < 2^22), less 1.5 * 2^23. The
// conversion instruction runs at a quarter of their rate.
__device__ __forceinline__ float i16_to_f32(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.0f;
}

// A warp's ring of NST slots over tiles j = 0, 1, ... of T rows of a
// time-major plane of E (row stride ld): tile j is rows j * T .. + T,
// columns [b0, b0 + width), kept only where the row is below hi; a slot
// holds T rows of 32 E, and the kernel reads them straight from its
// __shared__ array at the offset acquire() returns. Filled by 16-byte
// cp.async, so ld * sizeof(E), width * sizeof(E) and src are multiples
// of 16.
template <typename E, int T, int NST>
struct Ring {
  E* smem;
  const E* src;
  int ld, b0, width, lane, hi, ntiles;

  __device__ __forceinline__ void issue(int j) {
    if (j < ntiles) {
      E* d = smem + (j % NST) * T * 32;
      constexpr int PER = 16 / (int)sizeof(E);  // elements a chunk
      constexpr int CPR = 32 / PER;              // chunks a full row
      const int cpr = width / PER;
      for (int q = lane; q < T * CPR; q += 32) {
        const int r = q / CPR, k = q % CPR, row = j * T + r;
        if (k < cpr && row < hi)
          cp_async16(d + r * 32 + k * PER, src + (size_t)row * ld + b0 + k * PER);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  }

  // the first NST - 1 tiles in flight
  __device__ __forceinline__ void start() {
    for (int j = 0; j < NST - 1; ++j) issue(j);
  }

  // tile j, arrived, at the returned offset into the ring; the slot tile
  // j - 1 held refilled with tile j + NST - 1
  __device__ __forceinline__ int acquire(int j) {
    __syncwarp();
    issue(j + NST - 1);
    cp_async_wait<NST - 1>();
    __syncwarp();
    return (j % NST) * T * 32;
  }
};

// ---------------------------------------------------------------- a. prefix

// A block of two warps over 32 reads, one a sum: warp 0 runs the pA sums
// into A, warp 1 the sums of the f32 squares into Q, each from its own
// ring of the signal, as the two chains share only their input.
constexpr int PT = 64, PNST = 4;  // 64-row tiles of 64 B a row, 4 slots: 16 KB a warp

__global__ void __launch_bounds__(64)
    prefix_kernel(const int16_t* __restrict__ sig, const int32_t* __restrict__ ns,
                  const float* __restrict__ raw_unit, const float* __restrict__ offset, int S,
                  int B, double* __restrict__ A, double* __restrict__ Q,
                  double* __restrict__ end_sum, double* __restrict__ end_sumsq) {
  __shared__ __align__(16) int16_t rings[2][PNST * PT * 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * 32, b = b0 + lane;
  const bool on = b < B, sq = warp == 1;
  const int n = on ? ns[b] : 0;
  const float u = on ? raw_unit[b] : 0.0f, off = on ? offset[b] : 0.0f;
  const int nmax = __reduce_max_sync(FULL, n);
  int16_t* const ring = rings[warp];
  Ring<int16_t, PT, PNST> rg{ring, sig, B, b0, min(32, B - b0), lane, nmax,
                                  (nmax + PT - 1) / PT};
  rg.start();
  // only the f64 add chains from step to step: past n a step adds +0.0,
  // which leaves a sum bit for bit as it was (a sum of pA values, or of
  // squares, is never -0.0), so a step has no branch
  double acc = 0.0;
  double* pa = (sq ? Q : A) + (on ? b : 0);
  st_if(pa, 0.0, on);
  for (int j = 0; j < rg.ntiles; ++j) {
    const int o = rg.acquire(j) + lane;
    const int i0 = j * PT, rows = min(PT, S - i0);
#pragma unroll 8
    for (int r = 0; r < rows; ++r) {
      const float v = (i16_to_f32(ring[o + r * 32]) + off) * u;
      const double x = sq ? (double)(v * v) : (double)v;
      acc = acc + (i0 + r < n ? x : 0.0);
      pa += B;
      st_if(pa, acc, on);
    }
  }
  if (on) {  // frozen past the warp's longest read
    for (int i = rg.ntiles * PT; i < S; ++i) {
      pa += B;
      *pa = acc;
    }
    (sq ? end_sumsq : end_sum)[b] = acc;
  }
}

// ---------------------------------------------------------------- b. tstat

__device__ __forceinline__ float tstat(const double* A, const double* Q, int B, int b, int i,
                                       int n, int w, float wf32, double wf64) {
  if (i < w || i > n - w) return 0.0f;
  const size_t lo = (size_t)(i - w) * B + b, mid = (size_t)i * B + b, hi = (size_t)(i + w) * B + b;
  const double s_i = A[mid], q_i = Q[mid];
  const double sum1 = s_i - A[lo];
  const double sumsq1 = q_i - Q[lo];
  const float sum2 = (float)(A[hi] - s_i);
  const float sumsq2 = (float)(Q[hi] - q_i);
  const float mean1 = (float)(sum1 / wf64);
  const float mean2 = sum2 / wf32;
  double cvd = sumsq1 / wf64;
  cvd = cvd - (double)(mean1 * mean1);
  cvd = cvd + (double)(sumsq2 / wf32);
  cvd = cvd - (double)(mean2 * mean2);
  float cv = (float)cvd;
  if (cv < FLT_MIN) cv = FLT_MIN;  // np.maximum(cv, eta); cv is never NaN
  const float dm = mean2 - mean1;
  return (float)(fabs((double)dm) / sqrt((double)(cv / wf32)));
}

constexpr int TSTAT_THREADS = 256;

__global__ void __launch_bounds__(TSTAT_THREADS)
    tstat_kernel(const double* __restrict__ A, const double* __restrict__ Q,
                 const int32_t* __restrict__ ns, int S, int B, int w1, int w2,
                 float* __restrict__ t1, float* __restrict__ t2) {
  const size_t idx = (size_t)blockIdx.x * TSTAT_THREADS + threadIdx.x;
  if (idx >= (size_t)S * B) return;
  const int i = (int)(idx / B), b = (int)(idx % B);
  const int n = ns[b];
  const float wf1 = (float)w1, wf2 = (float)w2;
  t1[idx] = tstat(A, Q, B, b, i, n, w1, wf1, (double)wf1);
  t2[idx] = tstat(A, Q, B, b, i, n, w2, wf2, (double)wf2);
}

// ---------------------------------------------------------------- c. detector

// A block of three warps over 32 reads, each on its own chain: warp 0 runs
// the short detector over t1, warp 1 the long one over t2 a tile behind,
// warp 2 appends both's commits in the host's order two tiles behind.
// Warps 0 and 1 stream their planes through rings of their own; per step,
// warp 0 leaves the long detector's reset (or -1) and its commit (or 0),
// warp 1 its commit, in a shared record of the tile.
constexpr int DT = 32, DNST = 3;  // 32-row tiles of 128 B, 3 slots: 12 KB a ring
constexpr int DREC = 3;           // record tiles: warp 0's, warp 1's, warp 2's
constexpr int DET_THREADS = 96;

struct Rec {
  int reset;  // the long detector's masked_to from this step's short peak, or -1
  int sc;     // the short detector's committed position, or 0
  int lc;     // the long detector's, or 0
};

constexpr int DET_SMEM = 2 * DNST * DT * 32 * (int)sizeof(float) + DREC * DT * 32 * (int)sizeof(Rec);

struct Det {
  int masked_to;
  int pp;    // peak_pos, -1 while searching
  float pv;  // peak_value
  bool vp;   // valid_peak
};

// One detector's step i on t-stat c (events.c:375-447), straight-line:
// the host's searching and tracking branches folded into compares and
// selects on the step's old state, so the chain from one step to the next
// is a few operations. act: the detector is not masked at step i. Sets
// com (a commit of d.pp: a step that commits never rises, as half >= 1)
// and hot (tracking, the peak after the step's rise is over thr: the short
// detector then masks and resets the long one from hot_pos).
//   tracking: rise = c > pv; the peak after it is (c, i) on a rise, else
//   (pv, pp). It becomes valid when pv - c > ph and pv > thr (never on a
//   rise: c - c = 0 <= ph), and a valid peak more than half steps back
//   commits: pp = -1, pv = c, vp = false. searching: pv = c when c < pv,
//   or when c - pv > ph, which also sets pp = i.
__device__ __forceinline__ Det det_step(const Det d, bool act, float c, int i, float thr,
                                        float ph, int half, bool& com, bool& hot, int& hot_pos) {
  const bool srch = d.pp < 0;
  const bool trk = act & !srch;
  const bool rise = c > d.pv;
  const bool lt = c < d.pv;
  const bool fnd = !lt & (c - d.pv > ph);
  const bool over = d.pv > thr;
  const bool vp_t = d.vp | (!rise & (d.pv - c > ph) & over);
  com = trk & vp_t & !rise & (i - d.pp > half);
  hot = trk & (rise ? c > thr : over);
  hot_pos = rise ? i : d.pp;
  const bool take_c = srch ? (lt | fnd) : (rise | com);
  const bool to_i = srch ? fnd : rise;
  Det o;
  o.masked_to = d.masked_to;
  o.pv = act & take_c ? c : d.pv;
  o.pp = act & to_i ? i : (trk & com ? -1 : d.pp);
  o.vp = trk ? vp_t & !com : d.vp;
  return o;
}

// append a committed pos > 0 at wp, the read's next slot, while wp is
// short of its end
__device__ __forceinline__ void commit(int32_t*& wp, const int32_t* end, bool& overflow, int pos) {
  const bool eff = pos > 0;  // create_events keeps peaks in (0, n)
  const bool fits = eff & (wp < end);
  st_if(wp, pos, fits);
  wp += fits ? 1 : 0;
  overflow = overflow | (eff & !fits);
}

__global__ void __launch_bounds__(DET_THREADS)
    detector_kernel(const float* __restrict__ t1, const float* __restrict__ t2,
                    const int32_t* __restrict__ ns, int B, int E, int w1, int w2, float thr1,
                    float thr2, float ph, int32_t* __restrict__ peaks,
                    int32_t* __restrict__ counts, uint8_t* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const rings = reinterpret_cast<float*>(smem_raw);  // warp 0's, then warp 1's
  Rec* const recs = reinterpret_cast<Rec*>(rings + 2 * DNST * DT * 32);  // [DREC][DT][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * 32, b = b0 + lane;
  const bool on = b < B;
  const int n = on ? ns[b] : 0;
  const int nmax = __reduce_max_sync(FULL, n);
  const int ntiles = (nmax + DT - 1) / DT;
  float* const ring = rings + (warp & 1) * DNST * DT * 32;
  Ring<float, DT, DNST> rg{ring, warp == 0 ? t1 : t2, B, b0, min(32, B - b0), lane, nmax,
                                ntiles};
  if (warp < 2) rg.start();
  Det st = {0, -1, FLT_MAX, false};  // warp 0: the short detector, warp 1: the long one
  int32_t* const row = peaks + (size_t)(on ? b : 0) * E;
  const int32_t* const row_end = on ? row + E : row;  // a lane past B commits nothing
  int32_t* wp = row;
  bool ovf = false;
  // tile t of warp 0 at iteration t, of warp 1 at t + 1, of warp 2 at t + 2;
  // step 0 changes nothing: both detectors start masked to 0
  for (int it = 0; it < ntiles + 2; ++it) {
    const int t = it - warp;
    if (t >= 0 && t < ntiles) {
      Rec* const rc = recs + (t % DREC) * DT * 32 + lane;
      const int i0 = t * DT, rows = max(0, min(DT, n - i0));  // this read's steps here
      if (warp == 0) {
        const int o = rg.acquire(t) + lane;
#pragma unroll 4
        for (int r = t == 0 ? 1 : 0; r < rows; ++r) {
          const int i = i0 + r;
          bool com, hot;
          int hp;
          const int pos = st.pp;
          st = det_step(st, true, ring[o + r * 32], i, thr1, ph, w1 / 2, com, hot, hp);
          // a short peak over its threshold masks and resets the long detector
          // (events.c: long.masked_to = short.peak_pos + short.window_length)
          rc[r * 32].reset = hot ? hp + w1 : -1;
          rc[r * 32].sc = com ? pos : 0;
        }
      } else if (warp == 1) {
        const int o = rg.acquire(t) + lane;
#pragma unroll 4
        for (int r = t == 0 ? 1 : 0; r < rows; ++r) {
          const int i = i0 + r;
          const int reset = rc[r * 32].reset;
          const Det l0 = reset >= 0 ? Det{reset, -1, FLT_MAX, false} : st;
          bool com, unused;
          int unused_pos;
          st = det_step(l0, l0.masked_to < i, ring[o + r * 32], i, thr2, ph, w2 / 2, com,
                        unused, unused_pos);
          rc[r * 32].lc = com ? l0.pp : 0;
        }
      } else {
#pragma unroll 4
        for (int r = t == 0 ? 1 : 0; r < rows; ++r) {
          commit(wp, row_end, ovf, rc[r * 32].sc);  // short before long, as the host
          commit(wp, row_end, ovf, rc[r * 32].lc);
        }
      }
    }
    __syncthreads();
  }
  if (warp == 2 && on) {
    counts[b] = (int)(wp - row);
    overflow[b] = ovf ? 1 : 0;
  }
}

// ---------------------------------------------------------------- d. gather

constexpr int GATHER_THREADS = 256;

__global__ void __launch_bounds__(GATHER_THREADS)
    gather_kernel(const double* __restrict__ A, const double* __restrict__ Q,
                  const int32_t* __restrict__ counts, int B, int E, int32_t* __restrict__ peaks,
                  double* __restrict__ psum, double* __restrict__ psumsq) {
  const size_t idx = (size_t)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (idx >= (size_t)B * E) return;
  const int b = (int)(idx / E), k = (int)(idx % E);
  if (k < counts[b]) {
    const size_t at = (size_t)peaks[idx] * B + b;
    psum[idx] = A[at];
    psumsq[idx] = Q[at];
  } else {
    peaks[idx] = 0;
    psum[idx] = 0.0;
    psumsq[idx] = 0.0;
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the rings' chunks stay inside each plane's rows
bool whole_chunks(int B, const void* p, const void* q = nullptr) {
  return B % 8 == 0 && aligned16(p) && aligned16(q);
}

unsigned blocks(size_t cells, int threads) { return (unsigned)((cells + threads - 1) / threads); }

}  // namespace

// C entries, each one stage's launch on `stream`; each returns
// cudaGetLastError(). sf_events runs all four in order.
extern "C" int sf_events_prefix(const void* sig, const void* nsamples, const void* raw_unit,
                                const void* offset, int S, int B, void* A, void* Q,
                                void* end_sum, void* end_sumsq, void* stream) {
  if (B <= 0) return 0;
  if (!whole_chunks(B, sig)) return (int)cudaErrorInvalidValue;
  prefix_kernel<<<(B + 31) / 32, 64, 0, (cudaStream_t)stream>>>(
      (const int16_t*)sig, (const int32_t*)nsamples, (const float*)raw_unit,
      (const float*)offset, S, B, (double*)A, (double*)Q, (double*)end_sum, (double*)end_sumsq);
  return (int)cudaGetLastError();
}

extern "C" int sf_events_tstat(const void* A, const void* Q, const void* nsamples, int S, int B,
                               int w1, int w2, void* t1, void* t2, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  tstat_kernel<<<blocks((size_t)S * B, TSTAT_THREADS), TSTAT_THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)A, (const double*)Q, (const int32_t*)nsamples, S, B, w1, w2, (float*)t1,
      (float*)t2);
  return (int)cudaGetLastError();
}

extern "C" int sf_events_detect(const void* t1, const void* t2, const void* nsamples, int S,
                                int B, int E, int w1, int w2, float thr1, float thr2, float ph,
                                void* peaks, void* counts, void* overflow, void* stream) {
  // S = 0 still launches: every read's count and overflow flag are written
  if (B <= 0) return 0;
  if (!whole_chunks(B, t1, t2)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      detector_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DET_SMEM);
  if (e != cudaSuccess) return (int)e;
  detector_kernel<<<(B + 31) / 32, DET_THREADS, DET_SMEM, (cudaStream_t)stream>>>(
      (const float*)t1, (const float*)t2, (const int32_t*)nsamples, B, E, w1, w2, thr1, thr2,
      ph, (int32_t*)peaks, (int32_t*)counts, (uint8_t*)overflow);
  return (int)cudaGetLastError();
}

extern "C" int sf_events_gather(const void* A, const void* Q, const void* counts, int B, int E,
                                void* peaks, void* psum, void* psumsq, void* stream) {
  if (B <= 0 || E <= 0) return 0;
  gather_kernel<<<blocks((size_t)B * E, GATHER_THREADS), GATHER_THREADS, 0,
                  (cudaStream_t)stream>>>((const double*)A, (const double*)Q,
                                          (const int32_t*)counts, B, E, (int32_t*)peaks,
                                          (double*)psum, (double*)psumsq);
  return (int)cudaGetLastError();
}

// One eventizer call over a (S, B) batch: the four stages in order on
// `stream`. t1 and t2 are the wrapper's (S, B) f32 scratch planes; every
// output is written whole (the peak slots past a read's count get 0).
extern "C" int sf_events(const void* sig, const void* nsamples, const void* raw_unit,
                         const void* offset, int S, int B, int E, int w1, int w2, float thr1,
                         float thr2, float ph, void* A, void* Q, void* peaks, void* counts,
                         void* overflow, void* psum, void* psumsq, void* end_sum,
                         void* end_sumsq, void* t1, void* t2, void* stream) {
  int err = sf_events_prefix(sig, nsamples, raw_unit, offset, S, B, A, Q, end_sum, end_sumsq,
                             stream);
  if (err == 0) err = sf_events_tstat(A, Q, nsamples, S, B, w1, w2, t1, t2, stream);
  if (err == 0)
    err = sf_events_detect(t1, t2, nsamples, S, B, E, w1, w2, thr1, thr2, ph, peaks, counts,
                           overflow, stream);
  if (err == 0) err = sf_events_gather(A, Q, counts, B, E, peaks, psum, psumsq, stream);
  return err;
}

// The dynamic shared memory a detector block takes, in bytes (the other
// stages take none, or static shared memory).
extern "C" int sf_events_detector_smem(void) { return DET_SMEM; }
