// Batched RNA polyA autodetect for `--host-stages device` with -p -1:
// one thread a read, its samples streamed through shared memory.
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
// warp's lanes find a step's samples in 64 neighbouring bytes) four times:
//   P1+P2a  the rolling mean t of the clamped raw samples as jnn.c's
//           running accumulator (subtract, then add; jnn.c:37-46) and
//           the sequential f32 sum of t -> mean
//   P2b     the same t again (the accumulator is deterministic, so the
//           values are bit-identical) and the sum of (t - mean)^2 -> std,
//           bot = mean - std * scale
//   P3      t a third time through the jnnv2 segment machine (jnn.c:113-
//           168) -> the adaptor (ax, ay)
//   P4+P5   one walk from the adaptor: the f32 sum of the pA samples in
//           [ax, ay) -> m_a, then from ay the jnn_core machine (jnn.c:191-
//           279) over the clamped pA tail, the band (m_a + 30) +- 20 in
//           the C reference's f32 order (sigfish.c:396) -> s0e + ay, or -1
// Recomputing t costs a second cursor and three flops a step, beside the
// pass's own chain; storing t would cost a (S, B) f32 plane written once
// and read twice.
//
// Loads: each warp (a block of one warp, so the blocks spread over the
// SMs) streams its 32 columns through shared-memory rings filled a tile
// ahead by 16-byte cp.async, so B is a multiple of 8 and the plane starts
// 16-byte aligned (the wrapper pads a batch with reads of 0 samples; an
// entry given another B returns cudaErrorInvalidValue). The walks over t need two cursors, at k and at
// k - window (window = 2000), so each has its own double-buffered ring of
// 256-row tiles: 2 cursors x 2 slots x 256 rows x 64 B = 64 KB of dynamic
// shared memory; the last walk uses the first cursor's. A walk's rows are
// the warp's union of its lanes' rows; a lane works only on its own. A
// batch is B/32 warps (16 at B=512), one on each SM sub-partition it
// reaches, so a warp pays the full latency of each dependent instruction:
// a step's body is kept straight-line (an i16 converts on the integer and
// f32 pipes, the segment machine's updates are selects), and only the
// rare segment closes branch.
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
// 4 x S steps (the running sums and the two state machines), so a launch
// is bound by S times the latency of a step's recurrence.

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

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

constexpr int T = 256;  // rows a tile
constexpr int NC = 2;   // cursors: k and k - window
constexpr int SLOT = NC * T * 32;
constexpr int RING_BYTES = 2 * SLOT * (int)sizeof(int16_t);

// A warp's double-buffered ring over tiles j = 0, 1, ... of T rows of the
// (S, B) plane: cursor c's tile j is rows base + j * T + (c ? off1 : 0) .. + T,
// columns [b0, b0 + width), kept only where the row lies in [lo, hi); a
// slot holds NC tiles of T rows of 32 samples, which the kernel reads
// straight from its shared array at the offset acquire() returns, filled
// by 16-byte cp.async.
struct Ring {
  int16_t* smem;
  const int16_t* sig;
  int off1, ncur, B, b0, width, lane, base, lo, hi, ntiles;

  __device__ __forceinline__ void issue(int j) {
    if (j < ntiles) {
      int16_t* dst = smem + (j & 1) * SLOT;
      for (int c = 0; c < ncur; ++c) {
        const int r0 = base + j * T + (c ? off1 : 0);
        int16_t* d = dst + c * T * 32;
        const int cpr = width / 8;  // 16-byte chunks of the warp's row
        for (int q = lane; q < T * 4; q += 32) {
          const int r = q >> 2, k = q & 3, row = r0 + r;
          if (k < cpr && row >= lo && row < hi)
            cp_async16(d + r * 32 + k * 8, sig + (size_t)row * B + b0 + k * 8);
        }
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the count
  }

  // a walk over rows [base, end) from ncur cursors
  __device__ __forceinline__ void start(int base_, int end, int ncur_) {
    __syncwarp();  // the slots' earlier readers done
    base = base_;
    ncur = ncur_;
    lo = max(0, base_ + (ncur_ > 1 ? off1 : 0));
    hi = end;
    ntiles = end > base_ ? (end - base_ + T - 1) / T : 0;
    issue(0);
  }

  // tile j, arrived, at the returned offset; tile j + 1 in flight into the
  // other slot
  __device__ __forceinline__ int acquire(int j) {
    __syncwarp();
    issue(j + 1);
    cp_async_wait1();
    __syncwarp();
    return (j & 1) * SLOT;
  }
};

__device__ __forceinline__ float clamp_outlier(float x) {
  return fminf(fmaxf(x, 0.0f), 1200.0f);  // jnp.clip(x, 0, 1200)
}

// (float)x of an i16 x, exactly, on the integer and f32 pipes: 1.5 * 2^23
// + x is a float whose low bits hold x (|x| < 2^22), less 1.5 * 2^23. The
// conversion instruction runs at a quarter of their rate.
__device__ __forceinline__ float i16_to_f32(int x) {
  return __int_as_float(0x4B400000 + x) - 12582912.0f;
}

__device__ __forceinline__ float sample(const int16_t* ring, int at) {
  return clamp_outlier(i16_to_f32(ring[at]));
}

// One walk of jnn.c's running accumulator over this lane's steps
// [0, k_hi) (none unless live): tt = tt + x_k below the window, else
// (tt - x_{k - window}) + x_k, then body(k, tt) at each step k >= k_lo.
// Only tt and the body's own state chain from step to step; a tile past
// the window's first (warp-uniform) has no select on tt.
template <class Body>
__device__ __forceinline__ void walk_t(Ring& rg, const int16_t* ring, int lane, int kmax,
                                       int window, int k_lo, int k_hi, bool live, Body&& body) {
  float tt = 0.0f;
  rg.start(0, kmax, NC);
  for (int j = 0; j < rg.ntiles; ++j) {
    const int o = rg.acquire(j) + lane, kb = j * T;
    const int m = live ? max(0, min(T, k_hi - kb)) : 0;
    if (kb >= window) {
#pragma unroll 8
      for (int r = 0; r < m; ++r) {
        tt = (tt - sample(ring, o + (T + r) * 32)) + sample(ring, o + r * 32);
        body(kb + r, tt);
      }
    } else {
      for (int r = 0; r < m; ++r) {
        const int k = kb + r;
        const float x = sample(ring, o + r * 32);
        tt = k < window ? tt + x : (tt - sample(ring, o + (T + r) * 32)) + x;
        if (k >= k_lo) body(k, tt);
      }
    }
  }
}

__global__ void __launch_bounds__(32)
    polya_kernel(const int16_t* __restrict__ sig, const int32_t* __restrict__ ns,
                 const float* __restrict__ raw_unit, const float* __restrict__ offset, int B,
                 int window, float std_scale, int seg_dist2, int hi2, int lo2, int corrector,
                 int seg_dist1, int win1, int err1, float wst, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int16_t* ring = reinterpret_cast<int16_t*>(smem_raw);
  const int lane = threadIdx.x, b0 = blockIdx.x * 32, b = b0 + lane;
  const bool on = b < B;
  const int n = on ? ns[b] : 0;
  // jnn.c:171-176: a signal no longer than the window fails
  const bool live = on && n > window;
  const float inv_w = 1.0f / (float)window;
  const int k_lo = window - 1, k_hi = n - 1;  // t is valid at steps [window - 1, n - 2]
  const float nt = (float)(n - window);
  const int kmax = __reduce_max_sync(FULL, live ? k_hi : 0);
  Ring rg{ring, sig, -window, NC, B, b0, min(32, B - b0), lane, 0, 0, 0, 0};

  // P1 + P2a: t and its sequential sum
  float sum1 = 0.0f;
  walk_t(rg, ring, lane, kmax, window, k_lo, k_hi, live, [&](int, float tt) { sum1 = sum1 + tt * inv_w; });
  const float mn = sum1 / nt;

  // P2b: the std, with the reference's fused multiply-adds
  float sum2 = 0.0f;
  walk_t(rg, ring, lane, kmax, window, k_lo, k_hi, live, [&](int, float tt) {
    const float d = tt * inv_w - mn;
    sum2 = fmaf(d, d, sum2);
  });
  const float sd = sqrtf(sum2 / nt);
  const float bot = fmaf(-sd, std_scale, mn);

  // P3: the jnnv2 segment machine over t. A step below bot opens or
  // extends a segment (selects); a step above it closes an open one (a
  // branch, taken a few times a read)
  const int half = window / 2 - 1;
  bool begin = false, found = false, have_l = false;
  int start = 0, end = 0, l_s = 0, l_e = 0, r_x = 0, r_y = 0;
  walk_t(rg, ring, lane, kmax, window, k_lo, k_hi, live, [&](int k, float tt) {
    const float tv = tt * inv_w;
    const int jj = k - k_lo;
    const bool below = tv < bot;
    const bool close = tv > bot && begin;
    end = below && begin ? jj : end;
    start = below && !begin ? jj : start;
    begin = begin || below;
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
    }
  });
  int ax = 0, ay = 0;
  const int ln = l_e - l_s;
  if (have_l && !found && ln <= hi2 && ln >= lo2) {
    ax = l_s + half;
    ay = l_e + half;
  } else if (found) {
    ax = r_x;
    ay = r_y;
  }
  const bool tail = live && ay > 0;  // else no adaptor: sigfish.c's prefix fail

  // P4 + P5 in one walk from min(ax, ay): m_a, the mean pA over [ax, ay),
  // complete at row ay, where the jnn_core machine over the clamped pA
  // tail starts (segs[0] only)
  const float u = on ? raw_unit[b] : 0.0f, off = on ? offset[b] : 0.0f;
  const int w0 = __reduce_min_sync(FULL, tail ? min(ax, ay) : 0x7fffffff);
  const int w1 = __reduce_max_sync(FULL, tail ? n : 0);
  float sa = 0.0f, top = 0.0f, botp = 0.0f;
  bool prev = false, have0 = false, last0 = false;
  have_l = false;
  int err = 0, perr = 0, c = 0, w = corrector, s0e = 0;
  start = 0;
  l_e = 0;
  rg.start(w0, w1, 1);
  for (int j = 0; j < rg.ntiles; ++j) {
    const int o = rg.acquire(j) + lane, kb = w0 + j * T;
    if (!tail) continue;
    // P4 on this lane's rows [ax, ay) of the tile
    const int r4 = max(0, min(T, ay - kb));
    for (int r = max(0, ax - kb); r < r4; ++r)
      sa = sa + (i16_to_f32(ring[o + r * 32]) + off) * u;
    // P5 on its rows [ay, n)
    const int r5 = max(0, min(T, n - kb));
    if (r4 < r5 && kb + r4 == ay) {  // the band, once m_a is complete
      const int na = ay - ax > 1 ? ay - ax : 1;
      const float m30 = sa / (float)na + 30.0f;
      top = m30 + 20.0f;
      botp = m30 - 20.0f;
    }
    for (int r = r4; r < r5; ++r) {
      const int i_rel = kb + r - ay;
      const float a = clamp_outlier((i16_to_f32(ring[o + r * 32]) + off) * u);
      const bool in_r = (a < top) && (a > botp);
      const bool drop = !in_r && prev;
      const bool tolerate = drop && err < err1;
      const bool closing = drop && !tolerate;
      // a step in range or tolerated grows the run
      start = in_r && !prev ? i_rel : start;
      const bool grow = in_r || tolerate;
      const int c2 = c + 1;
      w = w + (in_r ? 1 : 0);
      perr = in_r ? 0 : perr + (tolerate ? 1 : 0);
      err = err + (tolerate ? 1 : 0);
      if (grow && c2 >= win1 && c2 >= w && c2 % w == 0) err = err - 1;
      c = grow ? c2 : c;
      prev = prev || in_r;
      if (closing) {
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
  if (on) out[b] = (tail && have0 && s0e > 0) ? s0e + ay : -1;
}

}  // namespace

// C entry: one launch over a (S, B) batch on `stream`. Returns
// cudaGetLastError().
extern "C" int sf_polya(const void* sig, const void* nsamples, const void* raw_unit,
                        const void* offset, int S, int B, int window, float std_scale,
                        int seg_dist2, int hi2, int lo2, int corrector, int seg_dist1, int win1,
                        int err1, float wst, void* out, void* stream) {
  if (B <= 0) return 0;
  // the ring's 16-byte chunks stay inside the plane's rows
  if (B % 8 != 0 || ((uintptr_t)sig & 15) != 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(polya_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
  if (e != cudaSuccess) return (int)e;
  polya_kernel<<<(B + 31) / 32, 32, RING_BYTES, (cudaStream_t)stream>>>(
      (const int16_t*)sig, (const int32_t*)nsamples, (const float*)raw_unit,
      (const float*)offset, B, window, std_scale, seg_dist2, hi2, lo2, corrector, seg_dist1, win1,
      err1, wst, (int32_t*)out);
  return (int)cudaGetLastError();
}

// The dynamic shared memory a polya block takes, in bytes.
extern "C" int sf_polya_ring_bytes(void) { return RING_BYTES; }
