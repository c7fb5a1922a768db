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
// A_{-1} and A_{-2}. With one warp per read, lane 0's up and diagonal
// neighbours wrap around to lane Q-1, as the TPU kernel's lane roll does;
// with several they are BIG. Either way they reach only rows below s.
//
// Precondition of the one-shot mode: every start lane s <= lane. Row s
// depends on nothing below it, so rows >= s, the emitted one among them, do
// not see what row 0's neighbours were (sdtw_pallas.py:117-122: "lanes < s
// compute garbage that can never leak"). ops/layout.shift_queries_for_clip
// gives s = W - qlen <= W - 1 = lane.
//
// Exactness: each cell is local + min(up, min-or-BIG(left, diag)) in f32, in
// that order; min is exact and nothing is reassociated, so the scores are
// bitwise equal to the plain PyTorch version (ops/sdtw_wavefront.py) for any
// number of warps per read. Build without --use_fast_math (denormals and
// IEEE adds kept) and with -fmad=false. Two forms of the cell differ from
// the plain version's selects and give the same bits because every A lies
// in [+0, BIG]: local >= +0 (fabsf), at most |x - PAD| ~ 1e18, far below
// half an ulp of BIG (2^103), so local + BIG rounds to BIG and no sum
// passes it. (1) The reset flag is carried as 0 or BIG, and
// min-or-BIG(left, diag) is max(min(left, diag), flag). (2) Where the
// free-start row is row 0 (FS0), it is given by its inputs: up 0 makes
// local + min(0, ld) = local; with std, up = rs ? 0 : left and diag +inf
// make it local + (rs ? 0 : left). The CPU tests check both forms against
// the plain version (tests/test_torch_wavefront.py).
//
// What bounds it on this card. A cell costs about 7 f32 operations (sub,
// abs, 2 min, 2 select, add) and there are B*Q*D cells; the (B, D) output,
// one f32 per diagonal per read, is small beside that. But each diagonal
// depends on the one before, so a read is a chain of D steps, and one warp
// issues its steps in order: a step costs its instructions plus the stalls
// on its shuffles and shared-memory loads, and it cannot overlap the next
// step by much. (chip_smoke.py phase 5 prints the cycles per diagonal.)
// - At large B there are enough reads to keep every scheduler issuing. At
//   B=512 one warp per read is one warp per scheduler, at about 200 cycles
//   a step for Q=256 (8 rows a lane), and two warps per read on half the
//   rows each gain about 10% in the one-shot mode (PERF.md; the carry
//   mode's numbers are below).
// - At small B (16 reads over 9.28M diagonals, a batch of clipped reads
//   on a bacterial reference) most of the card idles and each read's chain is the whole
//   time. Splitting its rows over more warps shortens every step: ~100
//   cycles at 4 warps per read (2 rows a lane) against ~200 at one. Eight
//   warps (1 row a lane) put two warps on a scheduler and gain less.
//
// Design. WARPS warps share one read (template parameter, 1, 2, 4 or 8;
// ops/sdtw_wavefront.wavefront_warps picks it from B and Q). Warp k holds
// rows [32k*ROWS, 32(k+1)*ROWS), ROWS = Q / (32*WARPS), lane t of it the
// ROWS consecutive rows from (32k+t)*ROWS, with their two carried diagonals
// in registers. A step is ROWS cells of register arithmetic plus three warp
// shuffles: the up neighbour of the lane's first row, and the reference
// value and reset flag that slide one row down per step. The diagonal
// neighbour of the first row is the previous step's shuffled up value,
// carried in a register.
//
// With WARPS = 1 there is no handoff and no barrier: that instance is the
// one-warp sweep of the first port, wrap included. Lane 31 reads the
// staged reference tile from shared memory and hands y[d] to lane 0 in the
// shuffle that carries the wrap; the emitted value travels to lane t by
// one more shuffle per step and 32 diagonals leave as one coalesced
// 128-byte row segment.
//
// With several, the sweep is a pipeline between warps, one 32-diagonal tile
// deep. Lane 31 of warp k-1 writes its last row's A_d, reference value and
// reset flag (as 0 or BIG) to a ring in shared memory (kRing tiles per warp
// boundary), four diagonals at a time; warp k reads them back one diagonal
// later, every lane the same 16 bytes (a broadcast) one group of four
// diagonals ahead, and lane 0 takes them in place of lane t-1's values
// (shfl.up). Warp 0 takes BIG and the reference, staged one diagonal on.
// Warp k sweeps a tile once warp k-1 has finished it (an mbarrier per ring
// slot, "full"), and warp k-1 reuses a slot once warp k has read it
// ("empty"). Cell (i, d) needs row i-1 only at d-1 and d-2, so nothing is
// waited for per diagonal and nothing block-wide after the barriers'
// set-up. Only warp 0 loads the reference tiles (one coalesced load per
// tile, prefetched one tile ahead); only the warp holding the emitted row
// writes the emitted values to shared memory, four at a time, and stores
// each tile's 32 as one row segment. A tile's steps run in groups of four,
// past its last diagonal on the launch's last tile: nothing carries beyond
// the launch, and what is past D is never emitted.
//
// Carry mode (CARRY = true, entry sf_wavefront_carry) also replaces
// sdtw_pallas.py::_wavefront_carry_kernel: the same sweep over one reference
// segment, with the two diagonals and the reference window read from an
// incoming state before the first diagonal and written to an outgoing state
// after the last. Segments chained through it give the scores of one pass
// over their concatenation, bit for bit: the registers of the sweep are
// exactly that state, so nothing is recomputed at a segment boundary. The
// state costs 2*B*Q + 2*Q floats each way, nothing beside the cells. The
// chunked route's main fold runs it at B=512, Q=256 over 32,000-diagonal
// segments, 291 launches a batch on one stream
// (ops/sdtw_wavefront.carry_warps picks the warps per read from B and Q).
// Its rows split over warps as above:
// - each warp loads its own rows of the state (a1, the rolled a2, the
//   windows), and writes its own rows of the outgoing state after its last
//   tile; the warps finish a tile apart;
// - on the segment's first step, lane 0 of warp k > 0 takes the warp
//   below's last row on the diagonal before the segment (A from a1_in, y
//   and the reset flag from the windows); warp 0's row 0 takes BIG for its
//   up and diagonal neighbours, as in the one-shot mode;
// - the rolled a2's element 0 is A_{d-2}[Q-1]: lane 31 of the last warp
//   writes it, and warp 0 does not;
// - the last group of four steps stops at the launch's last diagonal, whose
//   state leaves (the one-shot mode runs on past it).
// What it guarantees, given every start lane s <= lane: the scores bitwise
// equal to the plain version's for every warp count; with every s = 0, all
// of the outgoing state bitwise equal; with start lanes, the state at a1
// rows >= s, at the rolled a2's elements 0 and s+1..Q-1 and in all of the
// windows (ops/sdtw_wavefront.carry_state_mask). The rest are rows below s,
// made from BIG in place of the roll's wrap; row s depends only on itself,
// so no row >= s reads them, and chained launches keep their scores even
// when they use different warp counts. With one warp the wrap is the
// roll's and the whole state is exact.
//
// Without start lanes the flag-aware carry mode runs the FS0 instance:
// the free-start row is row 0, given by its inputs (above), so a cell has
// no compare against the free-start row.
//
// The flag-free body (carry_noflag_kernel, entry sf_wavefront_carry_noflag)
// runs each segment of the chunked route's main fold that has no reset
// flag set in its diagonals nor in the Q-1 columns before them that its
// incoming window holds (ops/chunked_ref.flag_free_segments): all but the
// few that hold or follow a track start or the PAD flush, ~288 of a
// bacterial genome's ~291. The flag-aware instances run the rest, and
// every other caller (the mesh ring, --dtw-std). The two chain in any
// order and at any warp counts, as each leaves the state carry_state_mask
// guarantees. Its cell is the recurrence alone, three
// instructions: x - y, one DPX min of up, left and diag, and |x - y| + min
// (the abs an operand modifier of the add). Each elision gives the plain
// version's bits because every A lies in [+0, BIG] (above):
// - no reset flag: with the flag 0, min-or-BIG(left, diag) is
//   max(min(left, diag), +0) = min(left, diag) bit for bit; the body reads
//   no flag, and writes the outgoing rswin as zeros, the plain version's
//   window under the precondition;
// - the min on bit patterns: non-negative floats, +0 to BIG, order as
//   their bits do as signed ints (no -0 arises: fabsf and sums of
//   non-negative values give +0), so __vimin3_s32 on the bits is the min;
// - the free-start row once a step: a read's start lane s is the same in
//   all its warps, so each warp branches once, before its tile loop, to a
//   copy of the loop for the register s % ROWS (or to the copy without a
//   free-start row where it holds none), in which the lane that holds row
//   s selects 0 for that row's up operand, one select a step: local +
//   min(0, ld) = local for every ld in [+0, BIG]. s = 0 costs nothing:
//   warp 0's lane 0 reads 0 as its up input from a tile of zeros, as the
//   other warps read theirs from the ring. Rows below s compute garbage
//   that row s, which takes nothing from its neighbours, never passes on;
//   carry_state_mask leaves them out. Full-length reads and the bucket's
//   padding rows (start lane 0) run at the FS0 pace in every warp, however
//   many clipped reads share the launch;
// - the emitted row: only the warp that holds it emits, from the register
//   lane % ROWS picked by the same branch, outside the loop;
// - the reference window: steps run in groups of four, d % 4 known at
//   compile time, and row r's value at step d is step d - r's input, kept
//   in yr[(d - r) % 4] (ROWS <= 4): the window slides by renaming, with no
//   move;
// - the handoff: only the warps below the last hold the store of their
//   last row (a third choice of copy), one store a step straight from
//   the registers that hold it; lane 0's inputs are read at a group's
//   start, not prefetched into registers carried round the loop, which
//   cost a move each (bench_carry's SASS counts showed both).
//
// What bounds the carry mode at the main fold's shape (B=512, Q=256,
// 32,000 diagonals; scripts/bench_carry.py on an H100, PERF.md has the
// numbers). Issue: a step is paid in instructions at about 1.9 SM cycles
// each with two warps a scheduler, in every instance measured, so an
// instruction less a step is time less. The flag-aware FS0 instance at 2
// warps per read issues 42.5 SASS instructions per diagonal per warp (52.5
// with start lanes: a compare and select per cell against the free-start
// row), the reset select, the window's moves and the emitted row's tree
// of selects (pick_row) among them; the flag-free body 18.75 to 24.75 over
// its copies at 2 warps, of which 12 are its cells'. The cuts kept in the
// flag-aware instances, each because phase 5's table showed it helping:
// rows over 2 warps per read (~1.9 warps a scheduler); the reset flag as 0
// or BIG with a max; the FS0 instance; in it, pick_row and warp 0's BIG up
// inputs read from a tile (bigs) instead of selected (in the instances
// with start lanes they made ptxas spill). The one-shot mode keeps its
// selects: the max form made its 1- and 4-warp instances slower. The
// launch's last 1-3 steps run after the groups of four in both: a
// cut-short group (a break among the shuffles) made ptxas guard every
// shuffle against divergence, and the 2-warp instance 40% slower. Two
// groups a loop pass made the 2-warp flag-aware instance slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>


namespace {

constexpr float kBig = 3.0e38f;
constexpr float kPad = 1.0e18f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRing = 4;  // handoff tiles in flight per warp boundary

// Reads per block: 128 threads up to 4 warps per read, one read of 256
// threads at 8.
template <int WARPS>
struct Block {
  static constexpr int kReads = WARPS >= 4 ? 1 : 4 / WARPS;
  static constexpr int kThreads = 32 * WARPS * kReads;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive (release at CTA scope): the arriving thread's earlier shared
// memory writes and reads are ordered before the phase completes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait (acquire at CTA scope) until the phase of the given parity completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// A reset flag: a bool, or a float 0 or 1 where it travels between warps
// in the one-shot mode; in the carry mode a float 0 or BIG (MAXFLAG).
__device__ __forceinline__ bool is_set(bool f) { return f; }
__device__ __forceinline__ bool is_set(float f) { return f != 0.0f; }

// One diagonal of a lane's ROWS rows: slide the reference window one row
// down (y_in, r_in enter row 0), then every cell from its neighbours on the
// two diagonals before; emit(r, value) sees each new cell.
// MAXFLAG: the flag is 0 or BIG, and min-or-BIG(left, diag) is
// max(min(left, diag), flag), one instruction where ptxas makes the select
// a compare, a move of BIG and two predicated instructions (the same bits,
// see the note at the top). FS0: the free-start row is row 0, and the
// caller has made row 0's up_in and dg_in give it (free_start_row0): no
// compare per cell. Else row fs_r of this lane, if any, is the free-start
// row.
template <int ROWS, bool STD, bool FS0, bool MAXFLAG, class Flag, class Emit>
__device__ __forceinline__ void sweep_step(const float (&x)[ROWS], float (&a1)[ROWS],
                                           float (&a2)[ROWS], float (&yw)[ROWS],
                                           Flag (&rw)[ROWS], float y_in, Flag r_in,
                                           float up_in, float dg_in, int fs_r, Emit emit) {
#pragma unroll
  for (int r = ROWS - 1; r > 0; --r) {
    yw[r] = yw[r - 1];
    rw[r] = rw[r - 1];
  }
  yw[0] = y_in;
  rw[0] = r_in;
#pragma unroll
  for (int r = ROWS - 1; r >= 0; --r) {
    const float up = r > 0 ? a1[r - 1] : up_in;
    const float dg = r > 0 ? a2[r - 1] : dg_in;
    const float left = a1[r];
    const float local = fabsf(x[r] - yw[r]);
    float ld;
    if constexpr (MAXFLAG) {
      ld = fmaxf(fminf(left, dg), rw[r]);
    } else {
      ld = is_set(rw[r]) ? kBig : fminf(left, dg);
    }
    float nv = local + fminf(up, ld);
    if (!FS0 && r == fs_r) {
      if (STD) {
        nv = local + (is_set(rw[r]) ? 0.0f : left);
      } else {
        nv = local;
      }
    }
    a2[r] = left;
    a1[r] = nv;
    emit(r, nv);
  }
}

// a[r] for an r that is the same in every lane (the emitted row): a tree
// of selects on r's bits, ceil(log2(ROWS)) predicates and ROWS-1 selects,
// where a select per row as each cell is made takes ROWS of each.
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

// Row 0's up and diagonal inputs where it is the free-start row (`on`)
// and FS0 leaves that to the caller: up 0 gives local + min(0, ld) =
// local; with std, up = rs ? 0 : left and diag = +inf give ld =
// max(left, flag), so local + min(up, ld) = local + (rs ? 0 : left). Bit
// for bit, since every A lies in [+0, BIG]. Selects, not a branch: only
// one lane of a read is on.
template <bool STD>
__device__ __forceinline__ void free_start_row0(bool on, float& up, float& dg, float left,
                                                float r_in) {
  const float u = STD && r_in == 0.0f ? left : 0.0f;
  up = on ? u : up;
  if (STD) dg = on ? __int_as_float(0x7f800000) : dg;
}

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

template <int ROWS, int WARPS, bool STD, bool CARRY, bool FS0>
__global__ void __launch_bounds__(Block<WARPS>::kThreads)
wavefront_kernel(const float* __restrict__ queries,    // (B, Q)
                 const float* __restrict__ ypad,       // (D,)
                 const float* __restrict__ rspad,      // (D,)
                 const int* __restrict__ start_lanes,  // (B,) or null
                 float* __restrict__ out,              // (B, D)
                 Carry c, int B, int D, int lane) {
  static_assert(WARPS == 1 || WARPS == 2 || WARPS == 4 || WARPS == 8, "WARPS in {1, 2, 4, 8}");
  constexpr bool SPLIT = WARPS > 1;
  constexpr int READS = Block<WARPS>::kReads;
  constexpr int Q = 32 * ROWS * WARPS;
  constexpr int NB = SPLIT ? WARPS - 1 : 1;  // warp boundaries of a read
  constexpr int RING = SPLIT ? kRing : 1;
  // the reference tile: y[d0 + t] with one warp per read, y[d0 + 1 + t]
  // with several
  __shared__ __align__(16) float ys[READS][32];
  __shared__ __align__(16) float rss[READS][32];
  // the handoff rings: diagonal d0 + j of a tile in slot tile % RING, entry j
  __shared__ __align__(16) float h_a[READS][NB][RING][32];
  __shared__ __align__(16) float h_y[READS][NB][RING][32];
  __shared__ __align__(16) float h_r[READS][NB][RING][32];
  __shared__ uint64_t bar_full[READS][NB][RING];
  __shared__ uint64_t bar_empty[READS][NB][RING];
  __shared__ __align__(16) float es[SPLIT ? READS : 1][32];  // the emitted values of a tile
  // FS0: warp 0 reads its lane 0's up inputs, BIG, from this tile as the
  // other warps read theirs from the ring: no select a step
  __shared__ __align__(16) float bigs[FS0 ? 32 : 1];

  const int t = threadIdx.x & 31;
  const int wb = threadIdx.x >> 5;  // warp of the block
  const int rb = wb / WARPS;        // read of the block
  const int wk = wb - rb * WARPS;   // warp of the read
  const int b = blockIdx.x * READS + rb;
  if constexpr (SPLIT) {
    if (threadIdx.x < READS * NB * RING) {
      mbar_init(&bar_full[0][0][0] + threadIdx.x, 1);   // lane 31 of warp k-1 arrives
      mbar_init(&bar_empty[0][0][0] + threadIdx.x, 1);  // lane 31 of warp k arrives
    }
    if constexpr (FS0) {
      if (threadIdx.x < 32) bigs[threadIdx.x] = kBig;
    }
    __syncthreads();  // the one block-wide barrier, before any warp leaves
  }
  if (b >= B) return;  // all warps of the read leave; no block barrier below

  const int row_t = (wk * 32 + t) * ROWS;  // this lane's first row
  // the reset flags: see is_set; kSet is a set flag's value
  using Flag = std::conditional_t<SPLIT || CARRY, float, bool>;
  constexpr float kSet = CARRY ? kBig : 1.0f;
  float x[ROWS], a1[ROWS], a2[ROWS], yw[ROWS];
  Flag rw[ROWS];
  const size_t row0 = (size_t)b * Q + row_t;  // this lane's first (b, row)
  float prev_up = kBig;  // A_{d-2} of the row above this lane's first
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    x[r] = queries[row0 + r];
    if (CARRY) {
      // a2 holds A_{d-2} unrolled: row row_t+r of A_{d-2} is element
      // row_t+r+1 of the rolled state. Its last row belongs to the next
      // lane's first element and is never read as a diagonal neighbour
      // (only a2[r-1] is), so it is left BIG.
      a1[r] = c.a1_in[row0 + r];
      a2[r] = r + 1 < ROWS ? c.a2_in[row0 + r + 1] : kBig;
      yw[r] = c.ywin_in[row_t + r];
      rw[r] = c.rswin_in[row_t + r] > 0.5f ? kSet : 0.0f;
    } else {
      a1[r] = kBig;
      a2[r] = kBig;
      yw[r] = kPad;
      rw[r] = Flag(0);
    }
  }
  // roll(A_{d-2})[row_t] = A_{d-2}[row_t-1]; row 0 of a split read takes
  // BIG, as its up neighbour does
  if (CARRY && !(SPLIT && row_t == 0)) prev_up = c.a2_in[row0];
  const int s = start_lanes ? start_lanes[b] : 0;
  const int fs_r = s - row_t;  // free-start row in this lane, if in [0, ROWS)
  const bool fs_row0 = row_t == 0;  // FS0: this lane's row 0 is the free-start row
  const int emit_t = (lane / ROWS) & 31;
  const int emit_r = lane % ROWS;
  const int src = (t + 31) & 31;  // lane t-1, and lane 31 for lane 0
  const bool first = wk == 0;     // stages the reference tiles
  const bool consumes = SPLIT && wk > 0;
  const bool produces = SPLIT && wk < WARPS - 1;
  const bool emits = !SPLIT || lane / (32 * ROWS) == wk;  // holds the emitted row
  const bool emit_lane = emits && t == emit_t;

  // reference tile prefetch: lane t holds y[d0 + 32 + off + t] for the
  // next tile
  constexpr int off = SPLIT ? 1 : 0;
  float ny = 0.0f, nr = 0.0f;
  if (first) {
    ny = t + off < D ? ypad[t + off] : kPad;
    nr = t + off < D ? rspad[t + off] : 0.0f;
    if (SPLIT || CARRY) nr = nr > 0.5f ? kSet : 0.0f;  // the flags as floats
  }
  float* orow = out + (size_t)b * D;
  float em = 0.0f;  // one warp per read: emitted value of diagonal d0 + t
  // several: lane 0's input on a tile's first step. The warp below's last
  // row on the diagonal before the tile: before the launch's first, the
  // fresh state's PAD, 0, BIG, or the incoming state's row; in warp 0,
  // y[d0] and BIG.
  float cy = kPad, ca = kBig, cr = 0.0f;
  if (SPLIT && first) {
    cy = ypad[0];
    cr = rspad[0] > 0.5f ? kSet : 0.0f;
  } else if (SPLIT && CARRY) {
    const int below = wk * 32 * ROWS - 1;  // the warp below's last row
    cy = c.ywin_in[below];
    cr = c.rswin_in[below] > 0.5f ? kSet : 0.0f;
    ca = c.a1_in[(size_t)b * Q + below];
  }

  for (int d0 = 0, tile = 0; d0 < D; d0 += 32, ++tile) {
    const int slot = tile % RING;
    if (first) {
      __syncwarp();
      ys[rb][t] = ny;
      rss[rb][t] = nr;
      __syncwarp();
      const int dn = d0 + 32 + off + t;
      ny = dn < D ? ypad[dn] : kPad;
      nr = dn < D ? rspad[dn] : 0.0f;
      if (SPLIT || CARRY) nr = nr > 0.5f ? kSet : 0.0f;
    }
    const int steps = min(32, D - d0);
    if constexpr (!SPLIT) {
      for (int k = 0; k < steps; ++k) {
        // slide the reference window one row down; lane 0 takes y[d]
        const float y_send = t == 31 ? ys[rb][k] : yw[ROWS - 1];
        const float y_in = __shfl_sync(kFull, y_send, src);
        Flag r_in;
        if constexpr (CARRY) {
          r_in = __shfl_sync(kFull, t == 31 ? rss[rb][k] : rw[ROWS - 1], src);
        } else {
          const bool r_send = t == 31 ? (rss[rb][k] > 0.5f) : rw[ROWS - 1];
          r_in = __shfl_sync(kFull, (int)r_send, src) != 0;
        }
        const float up_in = __shfl_sync(kFull, a1[ROWS - 1], src);
        float up_c = up_in, dg_c = prev_up;
        if constexpr (FS0) free_start_row0<STD>(fs_row0, up_c, dg_c, a1[0], r_in);
        float ev = 0.0f;
        sweep_step<ROWS, STD, FS0, CARRY>(x, a1, a2, yw, rw, y_in, r_in, up_c, dg_c, fs_r,
                                          [&](int r, float nv) {
                                            if (!FS0 && r == emit_r) ev = nv;
                                          });
        if constexpr (FS0) ev = pick_row(a1, emit_r);
        prev_up = up_in;
        const float e = __shfl_sync(kFull, ev, emit_t);
        if (k == t) em = e;
      }
      if (t < steps) orow[d0 + t] = em;
    } else {
      if (consumes) mbar_wait(&bar_full[rb][wk - 1][slot], (tile / RING) & 1);
      if (produces && tile >= RING) mbar_wait(&bar_empty[rb][wk][slot], (tile / RING - 1) & 1);
      // lane 0's inputs, read by every lane (a broadcast) four steps at a
      // time, one group ahead: step k takes entry k-1 of the tile (the
      // reference staged one diagonal on in warp 0, the warp below's
      // diagonal d-1 in the others), step 0 the last tile's entry 31
      const int wsrc = first ? 0 : wk - 1;
      const float4* sy = reinterpret_cast<const float4*>(first ? ys[rb] : h_y[rb][wsrc][slot]);
      const float4* sr = reinterpret_cast<const float4*>(first ? rss[rb] : h_r[rb][wsrc][slot]);
      const float4* sa =
          reinterpret_cast<const float4*>(FS0 && first ? bigs : h_a[rb][wsrc][slot]);
      float4* hy4 = reinterpret_cast<float4*>(h_y[rb][wk < NB ? wk : 0][slot]);
      float4* hr4 = reinterpret_cast<float4*>(h_r[rb][wk < NB ? wk : 0][slot]);
      float4* ha4 = reinterpret_cast<float4*>(h_a[rb][wk < NB ? wk : 0][slot]);
      float4* es4 = reinterpret_cast<float4*>(es[rb]);
      float4 ny4 = sy[0], nr4 = sr[0], na4 = sa[0];
      // one step; lane 0 takes (y0, r0, a0), the warp below's last row
      auto step = [&](float y0, float r0, float a0, float& e, float& ho_a, float& ho_y,
                      float& ho_r) {
        // lane t-1's last row; lane 0 takes the input from below, which
        // every lane holds
        const float y_up = __shfl_up_sync(kFull, yw[ROWS - 1], 1);
        const float r_up = __shfl_up_sync(kFull, rw[ROWS - 1], 1);
        const float a_up = __shfl_up_sync(kFull, a1[ROWS - 1], 1);
        const float y_in = t == 0 ? y0 : y_up;
        const float r_in = t == 0 ? r0 : r_up;
        const float up_in = t == 0 ? a0 : a_up;
        float up_c = up_in, dg_c = prev_up;
        if constexpr (FS0) free_start_row0<STD>(fs_row0, up_c, dg_c, a1[0], r_in);
        e = 0.0f;
        sweep_step<ROWS, STD, FS0, CARRY>(x, a1, a2, yw, rw, y_in, r_in, up_c, dg_c, fs_r,
                                          [&](int r, float nv) {
                                            if (!FS0 && r == emit_r) e = nv;
                                          });
        if constexpr (FS0) e = pick_row(a1, emit_r);
        prev_up = up_in;
        ho_a = a1[ROWS - 1];
        ho_y = yw[ROWS - 1];
        ho_r = rw[ROWS - 1];
      };
      // the one-shot mode runs whole groups of four steps, past the tile's
      // last diagonal too: their values are never emitted, and nothing
      // carries beyond the launch. The carry mode stops at the launch's
      // last diagonal, whose state leaves: the 1-3 steps past its last
      // whole group run one at a time below.
      const int whole = CARRY ? steps & ~3 : steps;
      // two groups a loop at 4 warps per read and 2 or more rows a lane
      // (the 16-row instance): about 10% faster there; slower at 2
      // and 8 warps, and it spills at 1 row a lane
#pragma unroll(WARPS == 4 && ROWS > 1 ? 2 : 1)
      for (int k0 = 0; k0 < whole; k0 += 4) {
        const float4 gy = ny4, gr = nr4, ga = na4;
        const int gn = ((k0 >> 2) + 1) & 7;
        ny4 = sy[gn];
        nr4 = sr[gn];
        na4 = sa[gn];
        const float yv[4] = {cy, gy.x, gy.y, gy.z};
        const float rv[4] = {cr, gr.x, gr.y, gr.z};
        const bool ga_up = FS0 || !first;  // ga holds lane 0's up inputs
        const float av[4] = {ca, ga_up ? ga.x : kBig, ga_up ? ga.y : kBig, ga_up ? ga.z : kBig};
        cy = gy.w;
        cr = gr.w;
        ca = ga_up ? ga.w : kBig;
        float ev[4], ho_a[4], ho_y[4], ho_r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) step(yv[j], rv[j], av[j], ev[j], ho_a[j], ho_y[j], ho_r[j]);
        if (produces && t == 31) {
          ha4[k0 >> 2] = make_float4(ho_a[0], ho_a[1], ho_a[2], ho_a[3]);
          hy4[k0 >> 2] = make_float4(ho_y[0], ho_y[1], ho_y[2], ho_y[3]);
          hr4[k0 >> 2] = make_float4(ho_r[0], ho_r[1], ho_r[2], ho_r[3]);
        }
        if (emit_lane) es4[k0 >> 2] = make_float4(ev[0], ev[1], ev[2], ev[3]);
      }
      if constexpr (CARRY) {
        const float* fy = reinterpret_cast<const float*>(sy);
        const float* fr = reinterpret_cast<const float*>(sr);
        const float* fa = reinterpret_cast<const float*>(sa);
        for (int k = whole; k < steps; ++k) {
          float e, o_a, o_y, o_r;
          if (k == whole) {
            step(cy, cr, ca, e, o_a, o_y, o_r);
          } else {
            step(fy[k - 1], fr[k - 1], FS0 || !first ? fa[k - 1] : kBig, e, o_a, o_y, o_r);
          }
          if (produces && t == 31) {
            reinterpret_cast<float*>(ha4)[k] = o_a;
            reinterpret_cast<float*>(hy4)[k] = o_y;
            reinterpret_cast<float*>(hr4)[k] = o_r;
          }
          if (emit_lane) es[rb][k] = e;
        }
      }
      if (t == 31) {
        if (produces) mbar_arrive(&bar_full[rb][wk][slot]);
        if (consumes) mbar_arrive(&bar_empty[rb][wk - 1][slot]);
      }
      if (emits) {
        __syncwarp();
        if (t < steps) orow[d0 + t] = es[rb][t];
        __syncwarp();
      }
    }
  }

  if (CARRY) {
    // the state after the last diagonal, rolled back into the carry form;
    // each warp writes its own rows when it is done
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      c.a1_out[row0 + r] = a1[r];
      if (!(SPLIT && row_t == 0 && r == 0)) c.a2_out[row0 + r] = r > 0 ? a2[r - 1] : prev_up;
    }
    // split: the rolled element 0 is A_{d-2}[Q-1], held by the last warp
    if (SPLIT && wk == WARPS - 1 && t == 31) c.a2_out[(size_t)b * Q] = a2[ROWS - 1];
    if (b == 0) {  // every read holds the same window
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        c.ywin_out[row_t + r] = yw[r];
        c.rswin_out[row_t + r] = rw[r] != 0.0f ? 1.0f : 0.0f;
      }
    }
  }
}

template <int ROWS, int WARPS>
int launch_rows(const float* q, const float* yp, const float* rp, const int* sl,
                float* out, const Carry& c, int B, int D, int lane, int std_,
                cudaStream_t stream) {
  constexpr int R = Block<WARPS>::kReads;
  const dim3 grid((B + R - 1) / R);
  const dim3 block(Block<WARPS>::kThreads);
  // the carry mode without start lanes (the chunked route's main fold)
  // runs the FS0 instance: its free-start row is row 0
  const bool carry = c.a1_in != nullptr;
  const bool fs0 = carry && sl == nullptr;
  if (fs0 && std_) {
    wavefront_kernel<ROWS, WARPS, true, true, true><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  } else if (fs0) {
    wavefront_kernel<ROWS, WARPS, false, true, true><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  } else if (carry && std_) {
    wavefront_kernel<ROWS, WARPS, true, true, false><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  } else if (carry) {
    wavefront_kernel<ROWS, WARPS, false, true, false><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  } else if (std_) {
    wavefront_kernel<ROWS, WARPS, true, false, false><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  } else {
    wavefront_kernel<ROWS, WARPS, false, false, false><<<grid, block, 0, stream>>>(q, yp, rp, sl, out, c, B, D, lane);
  }
  return 0;
}

// Q = 32 * ROWS1: the instances of every WARPS that divides ROWS1.
template <int ROWS1>
int launch_q(const float* q, const float* yp, const float* rp, const int* sl,
             float* out, const Carry& c, int B, int D, int lane, int std_,
             int warps, cudaStream_t s) {
  switch (warps) {
    case 1:
      return launch_rows<ROWS1, 1>(q, yp, rp, sl, out, c, B, D, lane, std_, s);
    case 2:
      if constexpr (ROWS1 % 2 == 0) return launch_rows<ROWS1 / 2, 2>(q, yp, rp, sl, out, c, B, D, lane, std_, s);
      break;
    case 4:
      if constexpr (ROWS1 % 4 == 0) return launch_rows<ROWS1 / 4, 4>(q, yp, rp, sl, out, c, B, D, lane, std_, s);
      break;
    case 8:
      if constexpr (ROWS1 % 8 == 0) return launch_rows<ROWS1 / 8, 8>(q, yp, rp, sl, out, c, B, D, lane, std_, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

int launch(const float* queries, const float* ypad, const float* rspad,
           const int* start_lanes, float* out, const Carry& c, int B, int Q,
           int D, int lane, int std_, int warps, cudaStream_t s) {
  if (lane < 0 || lane >= Q) return (int)cudaErrorInvalidValue;
  int err;
  switch (Q) {
    case 32: err = launch_q<1>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, warps, s); break;
    case 64: err = launch_q<2>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, warps, s); break;
    case 128: err = launch_q<4>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, warps, s); break;
    case 256: err = launch_q<8>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, warps, s); break;
    case 384: err = launch_q<12>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, warps, s); break;
    case 512: err = launch_q<16>(queries, ypad, rspad, start_lanes, out, c, B, D, lane, std_, warps, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// ---- The carry mode's flag-free body (sf_wavefront_carry_noflag) ----
//
// Its own kernel and step, sharing no logic with the instances above. A
// cell is the recurrence alone: x - y, min(up, left, diag) in one DPX
// instruction, and |x - y| + min (the abs an operand modifier of the
// add). No reset flag, no compare against the free-start row, no pick of
// the emitted row and no move of the reference window happens in a cell
// or a step; each is paid once a launch, a warp or a tile instead (the
// note at the top has why each gives the plain version's bits).

// f(integral_constant<int, v>) for the v in [LO, HI) that equals `v`
// (none if no v does): a runtime value, warp-uniform, turned into a
// compile-time one once, outside every loop.
template <int LO, int HI, class F>
__device__ __forceinline__ void with_const(int v, F&& f) {
  if constexpr (LO < HI) {
    if (v == LO) {
      f(std::integral_constant<int, LO>{});
    } else {
      with_const<LO + 1, HI>(v, f);
    }
  }
}

// f(integral_constant<int, j>) for j = 0 .. N-1, in order
template <int N, class F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (N > 0) {
    unroll<N - 1>(f);
    f(std::integral_constant<int, N - 1>{});
  }
}

// min(up, left, diag) of three values in [+0, BIG] on their bit patterns:
// non-negative floats order as their bits do as signed ints, so Hopper's
// three-way integer min (DPX) gives the float min's bits
__device__ __forceinline__ float min3(float up, float left, float dg) {
  return __int_as_float(__vimin3_s32(__float_as_int(up), __float_as_int(left), __float_as_int(dg)));
}

// One read a group of WARPS warps, warp k on rows [32k*ROWS, 32(k+1)*ROWS)
// as in the instances above (the same handoff ring and barriers), with
// ROWS in {1, 2, 4} and WARPS > 1. Its precondition beside theirs: no
// reset flag is set in the segment's diagonals nor in the Q-1 columns
// before them that the incoming window holds
// (ops/chunked_ref.flag_free_segments); it reads no flag and writes the
// outgoing rswin as zeros.
template <int ROWS, int WARPS>
__global__ void __launch_bounds__(Block<WARPS>::kThreads)
carry_noflag_kernel(const float* __restrict__ queries,    // (B, Q)
                    const float* __restrict__ ypad,       // (D,)
                    const int* __restrict__ start_lanes,  // (B,) or null
                    float* __restrict__ out,              // (B, D)
                    Carry c, int B, int D, int lane) {
  static_assert(WARPS == 2 || WARPS == 4 || WARPS == 8, "WARPS in {2, 4, 8}");
  static_assert(ROWS == 1 || ROWS == 2 || ROWS == 4, "ROWS divides a group of 4 steps");
  constexpr int READS = Block<WARPS>::kReads;
  constexpr int Q = 32 * ROWS * WARPS;
  constexpr int NB = WARPS - 1;  // warp boundaries of a read
  // warp 0's reference tile, y[d0 + 1 + t]
  __shared__ __align__(16) float ys[READS][32];
  // the handoff rings: diagonal d0 + 1 + j of a tile in slot tile % kRing,
  // entry j: the warp below's last row's A and reference value
  __shared__ __align__(16) float h_a[READS][NB][kRing][32];
  __shared__ __align__(16) float h_y[READS][NB][kRing][32];
  __shared__ uint64_t bar_full[READS][NB][kRing];
  __shared__ uint64_t bar_empty[READS][NB][kRing];
  __shared__ __align__(16) float es[READS][32];  // the emitted values of a tile
  // warp 0's lane 0 reads its up inputs, 0, from here as the other warps
  // read theirs from the ring: row 0 is the free-start row (up 0)
  __shared__ __align__(16) float zs[32];

  const int t = threadIdx.x & 31;
  const int wb = threadIdx.x >> 5;  // warp of the block
  const int rb = wb / WARPS;        // read of the block
  const int wk = wb - rb * WARPS;   // warp of the read
  const int b = blockIdx.x * READS + rb;
  if (threadIdx.x < READS * NB * kRing) {
    mbar_init(&bar_full[0][0][0] + threadIdx.x, 1);   // lane 31 of warp k-1 arrives
    mbar_init(&bar_empty[0][0][0] + threadIdx.x, 1);  // lane 31 of warp k arrives
  }
  if (threadIdx.x < 32) zs[threadIdx.x] = 0.0f;
  __syncthreads();  // the one block-wide barrier, before any warp leaves
  if (b >= B) return;

  const int row_t = (wk * 32 + t) * ROWS;     // this lane's first row
  const size_t row0 = (size_t)b * Q + row_t;  // this lane's first (b, row)
  // x, A_{d-1} and A_{d-2} of the lane's rows; yr[j] is y_in of the last
  // step d with d % 4 == j, so row r's reference value at step d is
  // yr[(d - r) % 4]: the window slides by renaming, not by moves
  float x[ROWS], a1[ROWS], a2[ROWS], yr[4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    x[r] = queries[row0 + r];
    // a2 holds A_{d-2} unrolled (see the flag-aware kernel); its last row
    // is never read as a diagonal neighbour
    a1[r] = c.a1_in[row0 + r];
    a2[r] = r + 1 < ROWS ? c.a2_in[row0 + r + 1] : kBig;
    yr[3 - r] = c.ywin_in[row_t + r];  // step -1: d % 4 == 3
  }
#pragma unroll
  for (int j = 0; j < 4 - ROWS; ++j) yr[j] = kPad;  // never read
  // A_{d-2} of the row above this lane's first; BIG for row 0
  float prev_up = row_t == 0 ? kBig : c.a2_in[row0];

  const bool first = wk == 0;  // stages the reference tiles
  const bool consumes = wk > 0;
  const bool produces = wk < WARPS - 1;
  // the free-start row s: 0 is row 0's up input from zs; else the lane
  // that holds it (one warp of the read) selects 0 for its up operand, on
  // the register s % ROWS, once a step
  const int s = start_lanes ? start_lanes[b] : 0;
  const int lo_row = wk * 32 * ROWS;
  const bool has_fs = s > 0 && s >= lo_row && s < lo_row + 32 * ROWS;
  const bool fs_lane = has_fs && t == ((s / ROWS) & 31);
  const bool has_em = lane / (32 * ROWS) == wk;  // holds the emitted row
  const bool emit_lane = has_em && t == ((lane / ROWS) & 31);

  // warp 0's reference prefetch: lane t holds y[d0 + 33 + t] for the next tile
  float ny = 0.0f;
  if (first) ny = t + 1 < D ? ypad[t + 1] : kPad;
  float* orow = out + (size_t)b * D;
  // lane 0's inputs on a tile's first step: the warp below's last row on
  // the diagonal before it (before the launch's first, the incoming
  // state's row); in warp 0, y[d0] and 0
  float cy, ca;
  if (first) {
    cy = ypad[0];
    ca = 0.0f;
  } else {
    const int below = lo_row - 1;  // the warp below's last row
    cy = c.ywin_in[below];
    ca = c.a1_in[(size_t)b * Q + below];
  }

  // the sweep, for this warp's free-start register FSR and emitted register
  // EMR (-1: none in this warp), and whether it hands its last row up
  // (PROD): one copy of the tile loop per combination
  auto sweep = [&](auto fsr_c, auto emr_c, auto prod_c) {
    constexpr int FSR = decltype(fsr_c)::value;
    constexpr int EMR = decltype(emr_c)::value;
    constexpr bool PROD = decltype(prod_c)::value;
    float* ha = h_a[rb][PROD ? wk : 0][0];  // this warp's ring, slot 0
    float* hy = h_y[rb][PROD ? wk : 0][0];
    // step k of a tile, J = its d % 4; lane 0 takes (y0, a0), the warp
    // below's last row; the emitted row's new value goes to e
    auto step = [&](auto j_c, float y0, float a0, float& e, int k, int slot) {
      constexpr int J = decltype(j_c)::value;
      // lane t-1's last row on the diagonal before; lane 0 takes the
      // input from below, which every lane holds
      const float y_up = __shfl_up_sync(kFull, yr[(J - ROWS) & 3], 1);
      const float a_up = __shfl_up_sync(kFull, a1[ROWS - 1], 1);
      const float up_in = t == 0 ? a0 : a_up;
      yr[J] = t == 0 ? y0 : y_up;
#pragma unroll
      for (int r = ROWS - 1; r >= 0; --r) {
        float up = r > 0 ? a1[r - 1] : up_in;
        if (r == FSR) up = fs_lane ? 0.0f : up;
        const float dg = r > 0 ? a2[r - 1] : prev_up;
        const float left = a1[r];
        const float diff = x[r] - yr[(J - r) & 3];
        a2[r] = left;
        a1[r] = fabsf(diff) + min3(up, left, dg);
      }
      prev_up = up_in;
      if constexpr (EMR >= 0) e = a1[EMR];
      if (PROD && t == 31) {  // the last row, for the warp above
        ha[slot * 32 + k] = a1[ROWS - 1];
        hy[slot * 32 + k] = yr[(J - (ROWS - 1)) & 3];
      }
    };
    for (int d0 = 0, tile = 0; d0 < D; d0 += 32, ++tile) {
      const int slot = tile % kRing;
      if (first) {
        __syncwarp();
        ys[rb][t] = ny;
        __syncwarp();
        const int dn = d0 + 33 + t;
        ny = dn < D ? ypad[dn] : kPad;
      }
      const int steps = min(32, D - d0);
      if (consumes) mbar_wait(&bar_full[rb][wk - 1][slot], (tile / kRing) & 1);
      if (PROD && tile >= kRing) mbar_wait(&bar_empty[rb][wk][slot], (tile / kRing - 1) & 1);
      // lane 0's inputs, read by every lane (a broadcast) four steps at a
      // time: step k takes entry k-1 of the tile, step 0 the last tile's
      // entry 31
      const int wsrc = first ? 0 : wk - 1;
      const float* fy = first ? ys[rb] : h_y[rb][wsrc][slot];
      const float* fa = first ? zs : h_a[rb][wsrc][slot];
      const float4* sy = reinterpret_cast<const float4*>(fy);
      const float4* sa = reinterpret_cast<const float4*>(fa);
      float4* es4 = reinterpret_cast<float4*>(es[rb]);
      const int whole = steps & ~3;
      for (int k0 = 0; k0 < whole; k0 += 4) {
        const float4 gy = sy[k0 >> 2], ga = sa[k0 >> 2];
        float e[4];
        step(std::integral_constant<int, 0>{}, cy, ca, e[0], k0, slot);
        step(std::integral_constant<int, 1>{}, gy.x, ga.x, e[1], k0 + 1, slot);
        step(std::integral_constant<int, 2>{}, gy.y, ga.y, e[2], k0 + 2, slot);
        step(std::integral_constant<int, 3>{}, gy.z, ga.z, e[3], k0 + 3, slot);
        cy = gy.w;
        ca = ga.w;
        if constexpr (EMR >= 0) {
          if (emit_lane) es4[k0 >> 2] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
      // the launch's last 1-3 steps, past its last whole group: its last
      // diagonal's state leaves, so nothing runs past it
      if (whole < steps) {
        unroll<3>([&](auto j_c) {
          constexpr int J = decltype(j_c)::value;
          if (whole + J < steps) {
            float e = 0.0f;
            step(j_c, J == 0 ? cy : fy[whole + J - 1], J == 0 ? ca : fa[whole + J - 1], e,
                 whole + J, slot);
            if (EMR >= 0 && emit_lane) es[rb][whole + J] = e;
          }
        });
      }
      if (t == 31) {
        if (PROD) mbar_arrive(&bar_full[rb][wk][slot]);
        if (consumes) mbar_arrive(&bar_empty[rb][wk - 1][slot]);
      }
      if constexpr (EMR >= 0) {
        __syncwarp();
        if (t < steps) orow[d0 + t] = es[rb][t];
        __syncwarp();
      }
    }
  };
  with_const<-1, ROWS>(has_fs ? s % ROWS : -1, [&](auto fsr_c) {
    with_const<-1, ROWS>(has_em ? lane % ROWS : -1, [&](auto emr_c) {
      if (produces) {
        sweep(fsr_c, emr_c, std::true_type{});
      } else {
        sweep(fsr_c, emr_c, std::false_type{});
      }
    });
  });

  // the state after the last diagonal, rolled back into the carry form;
  // each warp writes its own rows when it is done
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    c.a1_out[row0 + r] = a1[r];
    if (!(row_t == 0 && r == 0)) c.a2_out[row0 + r] = r > 0 ? a2[r - 1] : prev_up;
  }
  // the rolled element 0 is A_{d-2}[Q-1], held by the last warp
  if (wk == WARPS - 1 && t == 31) c.a2_out[(size_t)b * Q] = a2[ROWS - 1];
  if (b == 0) {  // every read holds the same window; no flag is set in it
    with_const<0, 4>((D - 1) & 3, [&](auto j_c) {
      constexpr int J = decltype(j_c)::value;  // the last step's d % 4
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        c.ywin_out[row_t + r] = yr[(J - r) & 3];
        c.rswin_out[row_t + r] = 0.0f;
      }
    });
  }
}

template <int ROWS, int WARPS>
int launch_noflag_rows(const float* q, const float* yp, const int* sl, float* out,
                       const Carry& c, int B, int D, int lane, cudaStream_t stream) {
  constexpr int R = Block<WARPS>::kReads;
  carry_noflag_kernel<ROWS, WARPS>
      <<<dim3((B + R - 1) / R), dim3(Block<WARPS>::kThreads), 0, stream>>>(q, yp, sl, out, c, B, D, lane);
  return 0;
}

// The flag-free instances (ops/sdtw_wavefront.noflag_built): 2 warps per
// read at Q = 64, 128 and 256 (1, 2 and 4 rows a lane), the chunked
// route's pick at every B. Few, as each holds a copy of its loop for every
// free-start and emitted register.
int launch_noflag(const float* q, const float* yp, const int* sl, float* out,
                  const Carry& c, int B, int Q, int D, int lane, int warps,
                  cudaStream_t s) {
  if (lane < 0 || lane >= Q) return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  switch (Q * 16 + warps) {
    case 64 * 16 + 2: err = launch_noflag_rows<1, 2>(q, yp, sl, out, c, B, D, lane, s); break;
    case 128 * 16 + 2: err = launch_noflag_rows<2, 2>(q, yp, sl, out, c, B, D, lane, s); break;
    case 256 * 16 + 2: err = launch_noflag_rows<4, 2>(q, yp, sl, out, c, B, D, lane, s); break;
  }
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes. Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape or a warp count it has no instance of.

// The one-shot mode, `warps` warps per read (1, 2, 4 or 8, dividing Q/32).
// Precondition: every start lane <= lane (see the note at the top).
extern "C" int sf_wavefront(const float* queries, const float* ypad,
                            const float* rspad, const int* start_lanes,
                            float* out, int B, int Q, int D, int lane, int std_,
                            int warps, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  const Carry none = {};
  return launch(queries, ypad, rspad, start_lanes, out, none, B, Q, D, lane,
                std_, warps, (cudaStream_t)stream);
}

// The carry mode: one reference segment of D >= 1 diagonals, seeded from
// the incoming state and writing the outgoing state, `warps` warps per
// read (1, 2, 4 or 8, dividing Q/32). Precondition: every start lane <=
// lane. The outputs must not alias the inputs (every read's warps read
// the incoming window, and warp k the last row of warp k-1).
extern "C" int sf_wavefront_carry(const float* queries, const float* ypad,
                                  const float* rspad, const int* start_lanes,
                                  const float* a1_in, const float* a2_in,
                                  const float* ywin_in, const float* rswin_in,
                                  float* out, float* a1_out, float* a2_out,
                                  float* ywin_out, float* rswin_out, int B,
                                  int Q, int D, int lane, int std_, int warps,
                                  void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || !a1_in || !a2_in || !ywin_in || !rswin_in) return (int)cudaErrorInvalidValue;
  const Carry c = {a1_in, a2_in, ywin_in, rswin_in, a1_out, a2_out, ywin_out, rswin_out};
  return launch(queries, ypad, rspad, start_lanes, out, c, B, Q, D, lane, std_, warps,
                (cudaStream_t)stream);
}

// The carry mode's flag-free body: as sf_wavefront_carry without reset
// flags (no rspad, no incoming rswin; the outgoing rswin is zeros), for a
// segment with no flag set in its diagonals nor in the Q-1 columns before
// them. `warps` and Q as launch_noflag lists them. Precondition:
// every start lane <= lane; the outputs must not alias the inputs.
extern "C" int sf_wavefront_carry_noflag(const float* queries, const float* ypad,
                                         const int* start_lanes, const float* a1_in,
                                         const float* a2_in, const float* ywin_in,
                                         float* out, float* a1_out, float* a2_out,
                                         float* ywin_out, float* rswin_out, int B, int Q,
                                         int D, int lane, int warps, void* stream) {
  if (B <= 0) return 0;
  if (D <= 0 || !a1_in || !a2_in || !ywin_in) return (int)cudaErrorInvalidValue;
  const Carry c = {a1_in, a2_in, ywin_in, nullptr, a1_out, a2_out, ywin_out, rswin_out};
  return launch_noflag(queries, ypad, start_lanes, out, c, B, Q, D, lane, warps,
                       (cudaStream_t)stream);
}
