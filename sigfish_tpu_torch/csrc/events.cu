// Batched event detection for `--host-stages device`: one thread a read.
//
// Replaces the XLA device code of sigfish_tpu/ops/events_device.py
// (_detect_events_jit: _prefix_sums, _tstat, _detector_scan and the
// boundary gather), which has no Pallas kernel and no exact torch
// counterpart: each stage is a sequential chain a read whose order is
// fixed bit for bit. The plain PyTorch version is
// sigfish_tpu_torch/ops/events_device.detect_peaks_plain; this kernel is
// held to it, and to the host eventizer (ops/events.detect_events), bit
// for bit.
//
// Layout: the (S, B) i16 signal plane is time-major, so a warp's 32
// lanes (32 reads) load 64 neighbouring bytes a step, and the (S+1, B)
// f64 prefix planes A and Q likewise. Each thread
//   1. walks its samples once: pA = (raw + offset) * raw_unit in f32,
//      A[i+1] = A[i] + (double)pA, Q[i+1] = Q[i] + (double)(pA * pA)
//      (the square rounded to f32 before the f64 add, events.c:303-305),
//      frozen past n, written to the planes;
//   2. walks steps 0..n-1 again: the two t-stats of step i from A and Q at
//      i - w, i, i + w (events.c:319-368, the host compute_tstat's
//      float/double mixing op by op), then the coupled short/long peak
//      detector (events.c:375-447) in the host's branch order; a commit
//      with pos > 0 appends pos and A[pos], Q[pos] (read back from the
//      planes: a peak can lag its commit by any number of steps), at most
//      E of them, past which the read's overflow flag is set;
//   3. writes A[n], Q[n] and its count.
//
// Exactness: built with -fmad=false (no contraction of a multiply into an
// add), nvcc's default -prec-div=true, -prec-sqrt=true and -ftz=false. The
// f32 quotient combined_var / w is subnormal on near-flat windows; a
// flushed quotient would give |dm| / sqrt(0) = inf where the host has a
// huge finite t-stat, so nothing here flushes: plain `/`, sqrt() and
// fabs(), no __fdividef, rsqrt or fma.
//
// What bounds it on the card: bytes are 2 in and 16 out a sample (the
// f64 planes) plus the planes read back, a few ms at most at 3.35 TB/s;
// operations ~70 a sample. But each read is one dependent chain of S
// steps (the f64 prefix adds, then the detector's state), and a batch is
// only B/32 warps, so a launch is bound by its chain: S steps times the
// latency of one step (the t-stat's two f64 divisions and square roots
// and the planes' loads, which the detector waits on). The design takes
// that bound: no ring buffer, the planes materialised (0.5 GB at the
// 2^25-cell cap), one warp a block so the warps spread over the SMs.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Det {
  int masked_to;
  int pp;    // peak_pos, -1 while searching
  float pv;  // peak_value
  bool vp;   // valid_peak
};

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

struct Out {
  int32_t* peaks;
  double* psum;
  double* psumsq;
  int E;
  int cnt;
  bool overflow;
};

__device__ __forceinline__ void commit(Out& o, const double* A, const double* Q, int B, int b,
                                       int pos) {
  if (pos <= 0) return;  // create_events keeps peaks in (0, n)
  if (o.cnt < o.E) {
    const size_t r = (size_t)b * o.E + o.cnt;
    o.peaks[r] = pos;
    o.psum[r] = A[(size_t)pos * B + b];
    o.psumsq[r] = Q[(size_t)pos * B + b];
    ++o.cnt;
  } else {
    o.overflow = true;
  }
}

__global__ void events_kernel(const int16_t* __restrict__ sig, const int32_t* __restrict__ ns,
                              const float* __restrict__ raw_unit, const float* __restrict__ offset,
                              int S, int B, int E, int w1, int w2, float thr1, float thr2, float ph,
                              double* A, double* Q, int32_t* peaks, int32_t* counts,
                              uint8_t* overflow, double* psum, double* psumsq, double* end_sum,
                              double* end_sumsq) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = ns[b];
  const float u = raw_unit[b], off = offset[b];

  // 1. prefix sums, frozen past n
  double s = 0.0, q = 0.0;
  A[b] = 0.0;
  Q[b] = 0.0;
  for (int i = 0; i < S; ++i) {
    if (i < n) {
      const float v = ((float)sig[(size_t)i * B + b] + off) * u;
      s = s + (double)v;
      q = q + (double)(v * v);
    }
    A[(size_t)(i + 1) * B + b] = s;
    Q[(size_t)(i + 1) * B + b] = q;
  }

  // 2. t-stats and the coupled detector, in the host's order
  const float wf1 = (float)w1, wf2 = (float)w2;
  const double wd1 = (double)wf1, wd2 = (double)wf2;
  const int half1 = w1 / 2, half2 = w2 / 2;
  Det sh = {0, -1, FLT_MAX, false}, lg = {0, -1, FLT_MAX, false};
  Out o = {peaks, psum, psumsq, E, 0, false};
  for (int i = 0; i < n; ++i) {
    const float c1 = tstat(A, Q, B, b, i, n, w1, wf1, wd1);
    const float c2 = tstat(A, Q, B, b, i, n, w2, wf2, wd2);
    if (sh.masked_to < i) {
      if (sh.pp == -1) {
        if (c1 < sh.pv) {
          sh.pv = c1;
        } else if (c1 - sh.pv > ph) {
          sh.pv = c1;
          sh.pp = i;
        }
      } else {
        if (c1 > sh.pv) {
          sh.pv = c1;
          sh.pp = i;
        }
        if (sh.pv > thr1) {  // mask and reset the long detector
          lg.masked_to = sh.pp + w1;
          lg.pp = -1;
          lg.pv = FLT_MAX;
          lg.vp = false;
        }
        if (sh.pv - c1 > ph && sh.pv > thr1) sh.vp = true;
        if (sh.vp && i - sh.pp > half1) {
          commit(o, A, Q, B, b, sh.pp);
          sh.pp = -1;
          sh.pv = c1;
          sh.vp = false;
        }
      }
    }
    if (lg.masked_to < i) {
      if (lg.pp == -1) {
        if (c2 < lg.pv) {
          lg.pv = c2;
        } else if (c2 - lg.pv > ph) {
          lg.pv = c2;
          lg.pp = i;
        }
      } else {
        if (c2 > lg.pv) {
          lg.pv = c2;
          lg.pp = i;
        }
        if (lg.pv - c2 > ph && lg.pv > thr2) lg.vp = true;
        if (lg.vp && i - lg.pp > half2) {
          commit(o, A, Q, B, b, lg.pp);
          lg.pp = -1;
          lg.pv = c2;
          lg.vp = false;
        }
      }
    }
  }

  // 3. the totals at n and the count
  end_sum[b] = A[(size_t)n * B + b];
  end_sumsq[b] = Q[(size_t)n * B + b];
  counts[b] = o.cnt;
  overflow[b] = o.overflow ? 1 : 0;
}

}  // namespace

// C entry: one launch over a (S, B) batch on `stream`; the wrapper
// zero-fills peaks, psum and psumsq. Returns cudaGetLastError().
extern "C" int sf_events(const void* sig, const void* nsamples, const void* raw_unit,
                         const void* offset, int S, int B, int E, int w1, int w2, float thr1,
                         float thr2, float ph, void* A, void* Q, void* peaks, void* counts,
                         void* overflow, void* psum, void* psumsq, void* end_sum,
                         void* end_sumsq, void* stream) {
  if (B <= 0) return 0;
  const int threads = 32;
  events_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)sig, (const int32_t*)nsamples, (const float*)raw_unit,
      (const float*)offset, S, B, E, w1, w2, thr1, thr2, ph, (double*)A, (double*)Q,
      (int32_t*)peaks, (int32_t*)counts, (uint8_t*)overflow, (double*)psum, (double*)psumsq,
      (double*)end_sum, (double*)end_sumsq);
  return (int)cudaGetLastError();
}
