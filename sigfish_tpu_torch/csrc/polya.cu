// Batched RNA polyA autodetect for `--host-stages device` with -p -1:
// one thread a read.
//
// Replaces the XLA device code of sigfish_tpu/ops/jnn_device.py
// (_polya_end_jit: five lax.scan passes with (B,) lanes), which has no
// Pallas kernel and no exact torch counterpart: every pass is a
// sequential f32 chain a read. The plain PyTorch version is
// sigfish_tpu_torch/ops/jnn_device.polya_end_plain; this kernel is held to
// it, and to sigfish_tpu's polya_end_batch on XLA's CPU backend, bit for
// bit.
//
// Each thread walks its read's samples (time-major (S, B) i16, so a
// warp's lanes load neighbouring addresses) five times:
//   P1+P2a  the rolling mean t of the clamped raw samples as jnn.c's
//           running accumulator (subtract, then add; jnn.c:37-46) and
//           the sequential f32 sum of t -> mean
//   P2b     the same t again (the accumulator is deterministic, so the
//           values are bit-identical) and the sum of (t - mean)^2 -> std,
//           bot = mean - std * scale
//   P3      t a third time through the jnnv2 segment machine (jnn.c:113-
//           168) -> the adaptor (ax, ay)
//   P4      the f32 sum of the pA samples in [ax, ay) -> m_a
//   P5      the jnn_core machine (jnn.c:191-279) over the clamped pA tail
//           from ay, the band (m_a + 30) +- 20 in the C reference's f32
//           order (sigfish.c:396) -> s0e + ay, or -1
// Recomputing t costs two loads and three flops a step; storing it would
// cost a (S, B) f32 plane written once and read twice.
//
// Exactness: built with -fmad=false, so no multiply is contracted into an
// add by the compiler. The reference's own compiler (XLA's CPU backend)
// does round three spots differently from a plain reading of the JAX
// code, and this kernel follows what it computes:
//   - t = tt / 2000 is compiled as tt * f32(1 / 2000) (a division by a
//     constant becomes a product with its reciprocal);
//   - the std sum acc + d * d and bot = mean - std * scale are each one
//     fused multiply-add, written here as explicit fmaf().
// Everything else is plain IEEE f32: `/` and sqrtf() at nvcc's default
// -prec-div=true and -prec-sqrt=true, no flush to zero.
//
// What bounds it on the card: 2 bytes in a sample per pass and 4 out a
// read, and ~10-30 integer and f32 operations a sample and pass, so
// neither bytes nor operations: each read is one dependent chain of about
// 5 x S steps (the running sums and the two state machines), and a batch
// is only B/32 warps, so a launch is bound by S times the latency of a
// step. The design takes that bound (one warp a block, to spread the
// warps over the SMs); no plane is stored.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clamp_outlier(float x) {
  return fminf(fmaxf(x, 0.0f), 1200.0f);  // jnp.clip(x, 0, 1200)
}

struct Roll {
  // jnn.c's running accumulator: t[k - window + 1] = tt_k * inv_w
  const int16_t* sig;
  int B, b, window;
  float tt;
  __device__ float step(int k) {
    const float x = clamp_outlier((float)sig[(size_t)k * B + b]);
    if (k < window) {
      tt = tt + x;
    } else {
      tt = (tt - clamp_outlier((float)sig[(size_t)(k - window) * B + b])) + x;
    }
    return tt;
  }
};

__global__ void polya_kernel(const int16_t* __restrict__ sig, const int32_t* __restrict__ ns,
                             const float* __restrict__ raw_unit, const float* __restrict__ offset,
                             int S, int B, int window, float std_scale, int seg_dist2, int hi2,
                             int lo2, int corrector, int seg_dist1, int win1, int err1, float wst,
                             int32_t* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int n = ns[b];
  if (n <= window) {  // jnn.c:171-176: the signal is shorter than the window
    out[b] = -1;
    return;
  }
  const float inv_w = 1.0f / (float)window;
  const int k_lo = window - 1, k_hi = n - 1;  // t is valid at steps [window - 1, n - 2]
  const float nt = (float)(n - window);

  // P1 + P2a: t and its sequential sum
  Roll r = {sig, B, b, window, 0.0f};
  float sum1 = 0.0f;
  for (int k = 0; k < k_hi; ++k) {
    const float tt = r.step(k);
    if (k >= k_lo) sum1 = sum1 + tt * inv_w;
  }
  const float mn = sum1 / nt;

  // P2b: the std, with the reference's fused multiply-adds
  r.tt = 0.0f;
  float sum2 = 0.0f;
  for (int k = 0; k < k_hi; ++k) {
    const float tt = r.step(k);
    if (k >= k_lo) {
      const float d = tt * inv_w - mn;
      sum2 = fmaf(d, d, sum2);
    }
  }
  const float sd = sqrtf(sum2 / nt);
  const float bot = fmaf(-sd, std_scale, mn);

  // P3: the jnnv2 segment machine over t
  const int half = window / 2 - 1;
  bool begin = false, found = false, have_l = false;
  int start = 0, end = 0, l_s = 0, l_e = 0, r_x = 0, r_y = 0;
  r.tt = 0.0f;
  for (int k = 0; k < k_hi; ++k) {
    const float tt = r.step(k);
    if (k < k_lo) continue;
    const float tv = tt * inv_w;
    const int j = k - k_lo;
    const bool below = tv < bot, above = tv > bot;
    const bool close = above && begin;
    if (close) {
      const bool merge = have_l && (start - l_e) < seg_dist2;
      const int ln = l_e - l_s;
      if (have_l && !merge && !found && ln <= hi2 && ln >= lo2) {
        r_x = l_s + half;
        r_y = l_e + half;
        found = true;
      }
      if (merge) {
        l_e = end;
      } else {
        l_s = start;
        l_e = end;
      }
      have_l = true;
      start = 0;
      end = 0;
      begin = false;
    } else if (below) {
      if (begin) {
        end = j;
      } else {
        start = j;
        begin = true;
      }
    }
  }
  int ax = 0, ay = 0;
  const int ln = l_e - l_s;
  if (have_l && !found && ln <= hi2 && ln >= lo2) {
    ax = l_s + half;
    ay = l_e + half;
  } else if (found) {
    ax = r_x;
    ay = r_y;
  }
  if (ay <= 0) {  // no adaptor: sigfish.c's prefix fail
    out[b] = -1;
    return;
  }

  // P4: m_a, the mean pA over the adaptor
  const float u = raw_unit[b], off = offset[b];
  float sa = 0.0f;
  for (int k = ax; k < ay; ++k) sa = sa + ((float)sig[(size_t)k * B + b] + off) * u;
  const int na = ay - ax > 1 ? ay - ax : 1;
  const float m_a = sa / (float)na;
  const float m30 = m_a + 30.0f;
  const float top = m30 + 20.0f, botp = m30 - 20.0f;

  // P5: the jnn_core machine over the clamped pA tail, segs[0] only
  bool prev = false, have0 = false, last0 = false;
  have_l = false;
  int err = 0, perr = 0, c = 0, w = corrector, s0e = 0;
  start = 0;
  l_e = 0;
  for (int k = ay; k < n; ++k) {
    const int i_rel = k - ay;
    const float a = clamp_outlier(((float)sig[(size_t)k * B + b] + off) * u);
    const bool in_r = (a < top) && (a > botp);
    if (in_r) {
      if (!prev) start = i_rel;
      const int c2 = c + 1;
      w = w + 1;
      perr = 0;
      if (c2 >= win1 && c2 >= w && c2 % w == 0) err = err - 1;
      c = c2;
      prev = true;
    } else if (prev) {
      if (err < err1) {
        const int c2 = c + 1;
        perr = perr + 1;
        err = err + 1;
        if (c2 >= win1 && c2 >= w && c2 % w == 0) err = err - 1;
        c = c2;
      } else {
        if (c >= win1 || ((float)c >= wst && !have_l)) {
          const int e = i_rel - perr;
          if (have_l && (start - l_e) < seg_dist1) {
            if (last0) s0e = e;
            l_e = e;
          } else {
            last0 = !have0;
            if (!have0) {
              s0e = e;
              have0 = true;
            }
            l_e = e;
          }
          have_l = true;
        }
        prev = false;
        c = 0;
        err = 0;
        perr = 0;
      }
    }
  }
  out[b] = (have0 && s0e > 0) ? s0e + ay : -1;
}

}  // namespace

// C entry: one launch over a (S, B) batch on `stream`. Returns
// cudaGetLastError().
extern "C" int sf_polya(const void* sig, const void* nsamples, const void* raw_unit,
                        const void* offset, int S, int B, int window, float std_scale,
                        int seg_dist2, int hi2, int lo2, int corrector, int seg_dist1, int win1,
                        int err1, float wst, void* out, void* stream) {
  if (B <= 0) return 0;
  const int threads = 32;
  polya_kernel<<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)sig, (const int32_t*)nsamples, (const float*)raw_unit,
      (const float*)offset, S, B, window, std_scale, seg_dist2, hi2, lo2, corrector, seg_dist1,
      win1, err1, wst, (int32_t*)out);
  return (int)cudaGetLastError();
}
