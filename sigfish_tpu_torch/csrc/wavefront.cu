// Batched subsequence DTW as an anti-diagonal wavefront, for Hopper (sm_90a).
//
// Replaces the TPU kernel sigfish_tpu/ops/sdtw_pallas.py::_wavefront_kernel
// (tile body _wavefront_tile). It computes the same function, not the same
// blocks: for every read b and anti-diagonal d,
//
//   A_d[i] = |x[i] - y[d-i]| + min(A_{d-1}[i-1],
//                                  rs[d-i] ? BIG : min(A_{d-1}[i], A_{d-2}[i-1]))
//
// with the free-start lane s (0, or a clipped read's start lane) set to
// |x - y|, or with std to |x - y| + (rs ? 0 : A_{d-1}[s]). It emits
// out[b, d] = A_d[lane]. y[d-i] for d < i is PAD with rs 0, and BIG seeds
// A_{-1} and A_{-2}. Lane 0's up and diagonal neighbours wrap around to lane
// Q-1, as the TPU kernel's lane roll does; either way they are overwritten or
// never reach the emitted lane.
//
// Exactness: each cell is local + min(up, min-or-BIG(left, diag)) in f32, in
// that order; min is exact and nothing is reassociated, so the result is
// bitwise equal to the plain PyTorch version (ops/sdtw_wavefront.py). Build
// without --use_fast_math (denormals and IEEE adds kept) and with
// -fmad=false.
//
// What bounds it on this card: ALU issue. A cell costs about 8 f32 operations
// (sub, abs, 2 min, 2 select, add, free-start select) and there are B*Q*D
// cells; the (B, D) output is one f32 per diagonal per read, small beside
// that (about 124 MB at B=512 over a 60.7k-column reference).
//
// Design: one warp per read. Lane t of the warp holds the ROWS consecutive
// query rows [t*ROWS, (t+1)*ROWS) and their two carried diagonals in
// registers, so a diagonal step is ROWS cells of register arithmetic plus
// three warp shuffles: the up neighbour of the lane's first row, and the
// reference value and reset flag that slide one row down per step. The
// diagonal neighbour of the first row is the previous step's shuffled up
// value, carried in a register. Reference values arrive in 32-diagonal tiles
// (one coalesced load per tile, prefetched one tile ahead, staged in shared
// memory per warp); the emitted values of 32 diagonals are gathered into one
// register per lane and stored as one coalesced 128-byte row segment. No
// block-wide barrier: warps run free. What this leaves on the table (the
// read count B bounds the number of warps, ~4 per SM at B=512) is later
// work.
//
// Carry mode (CARRY = true, entry sf_wavefront_carry) also replaces
// sdtw_pallas.py::_wavefront_carry_kernel: the same sweep over one reference
// segment, with the two diagonals and the reference window read from an
// incoming state before the first diagonal and written to an outgoing state
// after the last. Segments chained through it give the scores of one pass
// over their concatenation, bit for bit: the registers of the sweep are
// exactly that state, so nothing is recomputed at a segment boundary. The
// state costs 2*B*Q + 2*Q floats each way, nothing beside the cells.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 3.0e38f;
constexpr float kPad = 1.0e18f;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// Cross-segment state of the carry mode (CARRY = true), in the JAX
// package's form (sdtw_pallas.py::sdtw_wavefront_carry): a1 = A_{d-1} and
// a2 = roll(A_{d-2}) by one lane, (B, Q) each; ywin[i] = y[d-1-i] and
// rswin[i] its reset flag as f32 0/1, (Q,) each. Null in the one-shot mode.
struct Carry {
  const float* a1_in;
  const float* a2_in;
  const float* ywin_in;
  const float* rswin_in;
  float* a1_out;
  float* a2_out;
  float* ywin_out;
  float* rswin_out;
};

template <int ROWS, bool STD, bool CARRY>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
wavefront_kernel(const float* __restrict__ queries,    // (B, Q)
                 const float* __restrict__ ypad,       // (D,)
                 const float* __restrict__ rspad,      // (D,)
                 const int* __restrict__ start_lanes,  // (B,) or null
                 float* __restrict__ out,              // (B, D)
                 Carry c, int B, int D, int lane) {
  constexpr int Q = 32 * ROWS;
  __shared__ float ys[kWarpsPerBlock][32];
  __shared__ float rss[kWarpsPerBlock][32];

  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + w;
  if (b >= B) return;  // whole warp leaves; no block barrier below

  float x[ROWS], a1[ROWS], a2[ROWS], yw[ROWS];
  bool rw[ROWS];
  const size_t row0 = (size_t)b * Q + t * ROWS;  // this lane's first (b, row)
  float prev_up = kBig;  // A_{d-2} of the row above this lane's first
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    x[r] = queries[row0 + r];
    if (CARRY) {
      // a2 holds A_{d-2} unrolled: row t*ROWS+r of A_{d-2} is element
      // t*ROWS+r+1 of the rolled state. Its last row belongs to the next
      // lane's first element and is never read as a diagonal neighbour
      // (only a2[r-1] is), so it is left BIG.
      a1[r] = c.a1_in[row0 + r];
      a2[r] = r + 1 < ROWS ? c.a2_in[row0 + r + 1] : kBig;
      yw[r] = c.ywin_in[t * ROWS + r];
      rw[r] = c.rswin_in[t * ROWS + r] > 0.5f;
    } else {
      a1[r] = kBig;
      a2[r] = kBig;
      yw[r] = kPad;
      rw[r] = false;
    }
  }
  if (CARRY) prev_up = c.a2_in[row0];  // roll(A_{d-2})[t*ROWS] = A_{d-2}[t*ROWS-1]
  const int s = start_lanes ? start_lanes[b] : 0;
  const int fs_r = s - t * ROWS;  // free-start row in this lane, if in [0, ROWS)
  const int emit_t = lane / ROWS;
  const int emit_r = lane - emit_t * ROWS;
  const int src = (t + 31) & 31;  // lane t-1, and lane 31 for lane 0
  float em = 0.0f;                // emitted value of diagonal d0 + t

  // reference tile prefetch: lane t holds y[d0 + 32 + t] for the next tile
  float ny = t < D ? ypad[t] : kPad;
  float nr = t < D ? rspad[t] : 0.0f;
  float* orow = out + (size_t)b * D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    __syncwarp();
    ys[w][t] = ny;
    rss[w][t] = nr;
    __syncwarp();
    const int dn = d0 + 32 + t;
    ny = dn < D ? ypad[dn] : kPad;
    nr = dn < D ? rspad[dn] : 0.0f;
    const int steps = min(32, D - d0);
    for (int k = 0; k < steps; ++k) {
      // slide the reference window one row down; lane 0 takes y[d]
      const float y_send = t == 31 ? ys[w][k] : yw[ROWS - 1];
      const bool r_send = t == 31 ? (rss[w][k] > 0.5f) : rw[ROWS - 1];
      const float y_in = __shfl_sync(kFull, y_send, src);
      const bool r_in = __shfl_sync(kFull, (int)r_send, src) != 0;
      const float up_in = __shfl_sync(kFull, a1[ROWS - 1], src);
#pragma unroll
      for (int r = ROWS - 1; r > 0; --r) {
        yw[r] = yw[r - 1];
        rw[r] = rw[r - 1];
      }
      yw[0] = y_in;
      rw[0] = r_in;

      float ev = 0.0f;
#pragma unroll
      for (int r = ROWS - 1; r >= 0; --r) {
        const float up = r > 0 ? a1[r - 1] : up_in;
        const float dg = r > 0 ? a2[r - 1] : prev_up;
        const float left = a1[r];
        const float local = fabsf(x[r] - yw[r]);
        const float ld = rw[r] ? kBig : fminf(left, dg);
        float nv = local + fminf(up, ld);
        if (r == fs_r) {
          if (STD) {
            nv = local + (rw[r] ? 0.0f : left);
          } else {
            nv = local;
          }
        }
        a2[r] = left;
        a1[r] = nv;
        if (r == emit_r) ev = nv;
      }
      prev_up = up_in;

      const float e = __shfl_sync(kFull, ev, emit_t);
      if (k == t) em = e;
    }
    if (t < steps) orow[d0 + t] = em;
  }

  if (CARRY) {
    // the state after the last diagonal, rolled back into the carry form
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      c.a1_out[row0 + r] = a1[r];
      c.a2_out[row0 + r] = r > 0 ? a2[r - 1] : prev_up;
    }
    if (b == 0) {  // every warp holds the same window
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        c.ywin_out[t * ROWS + r] = yw[r];
        c.rswin_out[t * ROWS + r] = rw[r] ? 1.0f : 0.0f;
      }
    }
  }
}

template <int ROWS>
void launch_rows(const float* q, const float* yp, const float* rp,
                 const int* sl, float* out, const Carry& c, int B, int D,
                 int lane, int std_, cudaStream_t stream) {
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  const bool carry = c.a1_in != nullptr;
  if (carry && std_) {
    wavefront_kernel<ROWS, true, true><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  } else if (carry) {
    wavefront_kernel<ROWS, false, true><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  } else if (std_) {
    wavefront_kernel<ROWS, true, false><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  } else {
    wavefront_kernel<ROWS, false, false><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  }
}

int launch(const float* queries, const float* ypad, const float* rspad,
           const int* start_lanes, float* out, const Carry& c, int B, int Q,
           int D, int lane, int std_, cudaStream_t s) {
  if (lane < 0 || lane >= Q) return (int)cudaErrorInvalidValue;
  switch (Q) {
    case 32: launch_rows<1>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, s); break;
    case 64: launch_rows<2>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, s); break;
    case 128: launch_rows<4>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, s); break;
    case 256: launch_rows<8>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, s); break;
    case 384: launch_rows<12>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, s); break;
    case 512: launch_rows<16>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes. Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 on success).
extern "C" int sf_wavefront(const float* queries, const float* ypad,
                            const float* rspad, const int* start_lanes,
                            float* out, int B, int Q, int D, int lane, int std_,
                            void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const Carry none = {};
  return launch(queries, ypad, rspad, start_lanes, out, none, B, Q, D, lane,
                std_, (cudaStream_t)stream);
}

// The carry mode: one reference segment of D >= 1 diagonals, seeded from
// the incoming state and writing the outgoing state. The outputs must not
// alias the inputs (every warp reads the incoming window).
extern "C" int sf_wavefront_carry(const float* queries, const float* ypad,
                                  const float* rspad, const int* start_lanes,
                                  const float* a1_in, const float* a2_in,
                                  const float* ywin_in, const float* rswin_in,
                                  float* out, float* a1_out, float* a2_out,
                                  float* ywin_out, float* rswin_out, int B,
                                  int Q, int D, int lane, int std_,
                                  void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || !a1_in || !a2_in || !ywin_in || !rswin_in) return (int)cudaErrorInvalidValue;
  const Carry c = {a1_in, a2_in, ywin_in, rswin_in, a1_out, a2_out, ywin_out, rswin_out};
  return launch(queries, ypad, rspad, start_lanes, out, c, B, Q, D, lane, std_,
                (cudaStream_t)stream);
}
