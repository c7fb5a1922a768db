// Native host-side kernels for sigfish-tpu.
//
// The TPU owns the batched sDTW scoring; these are the sequential,
// data-dependent host stages where scalar order matters for exactness
// and Python is 50-100x too slow on the per-read path:
//
//   - subsequence/standard DTW window recompute for winner backtracking
//     (semantics of sigfish src/cdtw.c:70-94,172-189; scalar operation
//     order preserved so float comparisons match the C reference)
//   - greedy path backtrack with the reference's tie-breaks
//     (src/cdtw.c:98-167: diag > left > up on float equality, and the
//     row-0 stutter strip of subsequence_path, src/cdtw.c:192-227)
//   - t-test event segmentation (src/events.c Scrappie-derived detector;
//     exact port of the validated Python oracle in ops/events.py,
//     including the reference's float/double mixing)
//
// Exposed with a plain C ABI and driven from Python via ctypes (no
// pybind11 in this environment).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cfloat>
#include <cstdlib>

#include <zlib.h>
// SF_NO_DEFLATE_ZSTD: a host without the libdeflate and zstd headers gets
// everything but the zlib/zstd-wrapped BLOW5 decode, which then returns -1
// (the caller decodes such records in Python)
#ifndef SF_NO_DEFLATE_ZSTD
#include <libdeflate.h>
#include <zstd.h>
#endif

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------- DTW

// Subsequence DP over a column window, exact scalar order.
// x: query (n), y: ref columns (m), cost out (n*m) row-major [i*m+j].
// First column is cumulative (window-local free start; callers retry
// with a wider window if the backtrack touches the left edge).
// ref: subsequence cdtw.c:172-189.
void sf_subsequence(const float* x, int32_t n, const float* y, int32_t m,
                    float* cost) {
    for (int32_t j = 0; j < m; j++) cost[j] = fabsf(x[0] - y[j]);
    float acc = cost[0];
    for (int32_t i = 1; i < n; i++) {
        acc += fabsf(x[i] - y[0]);
        cost[(int64_t)i * m] = acc;
    }
    for (int32_t i = 1; i < n; i++) {
        const float xi = x[i];
        const float* prev = cost + (int64_t)(i - 1) * m;
        float* cur = cost + (int64_t)i * m;
        float up_acc = cur[0];
        for (int32_t j = 1; j < m; j++) {
            float mn = prev[j];                      // left in col scan
            if (prev[j - 1] < mn) mn = prev[j - 1];  // diag
            if (up_acc < mn) mn = up_acc;            // up (this row, j-1)
            up_acc = fabsf(xi - y[j]) + mn;
            cur[j] = up_acc;
        }
    }
}

// Standard DTW (boundary anchored). ref: std_dtw cdtw.c:70-94.
void sf_std_dtw(const float* x, int32_t n, const float* y, int32_t m,
                float* cost, int32_t squared) {
#define DIST(a, b) (squared ? ((a) - (b)) * ((a) - (b)) : fabsf((a) - (b)))
    cost[0] = DIST(x[0], y[0]);
    for (int32_t j = 1; j < m; j++) cost[j] = cost[j - 1] + DIST(x[0], y[j]);
    for (int32_t i = 1; i < n; i++)
        cost[(int64_t)i * m] = cost[(int64_t)(i - 1) * m] + DIST(x[i], y[0]);
    for (int32_t i = 1; i < n; i++) {
        const float xi = x[i];
        const float* prev = cost + (int64_t)(i - 1) * m;
        float* cur = cost + (int64_t)i * m;
        for (int32_t j = 1; j < m; j++) {
            float mn = prev[j];
            if (prev[j - 1] < mn) mn = prev[j - 1];
            if (cur[j - 1] < mn) mn = cur[j - 1];
            cur[j] = DIST(xi, y[j]) + mn;
        }
    }
#undef DIST
}

// Greedy backtrack from (n-1, starty); px/py must hold n+m entries.
// Returns path length k (forward order). ref: path cdtw.c:98-167.
int32_t sf_path(const float* cost, int32_t n, int32_t m, int32_t starty,
                int32_t* px, int32_t* py) {
    int32_t i = n - 1, j = starty;
    int32_t k = 0;
    px[k] = i; py[k] = j; k++;
    while (i > 0 || j > 0) {
        if (i == 0) {
            j--;
        } else if (j == 0) {
            i--;
        } else {
            float up = cost[(int64_t)(i - 1) * m + j];
            float diag = cost[(int64_t)(i - 1) * m + j - 1];
            float left = cost[(int64_t)i * m + j - 1];
            float mn = up;
            if (diag < mn) mn = diag;
            if (left < mn) mn = left;
            if (diag == mn) { i--; j--; }
            else if (left == mn) { j--; }
            else { i--; }
        }
        px[k] = i; py[k] = j; k++;
    }
    for (int32_t a = 0, b = k - 1; a < b; a++, b--) {
        int32_t t = px[a]; px[a] = px[b]; px[b] = t;
        t = py[a]; py[a] = py[b]; py[b] = t;
    }
    return k;
}

// Subsequence backtrack: path then strip the leading row-0 stutter,
// keeping the last row-0 entry. Returns new length; shifts in place.
// ref: subsequence_path cdtw.c:192-227.
int32_t sf_subsequence_path(const float* cost, int32_t n, int32_t m,
                            int32_t starty, int32_t* px, int32_t* py) {
    int32_t k = sf_path(cost, n, m, starty, px, py);
    int32_t a_star = 0;
    for (int32_t i = 1; i < k; i++) {
        if (px[i] == 0) a_star++;
        else break;
    }
    if (a_star > 0) {
        memmove(px, px + a_star, sizeof(int32_t) * (k - a_star));
        memmove(py, py + a_star, sizeof(int32_t) * (k - a_star));
    }
    return k - a_star;
}

// Anti-diagonal subsequence DP: on diagonal d = i + j every cell
//   A_d[i] = |x[i] - y[d-i]| + min(A_{d-1}[i-1], A_{d-1}[i], A_{d-2}[i-1])
// is independent, so the inner loop auto-vectorizes (contiguous loads
// from two compact diagonal buffers). Per-cell operations are identical
// to the row-major loop, so the cost matrix is bitwise identical --
// only the evaluation order across independent cells changes.
static void subsequence_diag(const float* __restrict x, int32_t n,
                             const float* __restrict y, int32_t m,
                             float* __restrict cost,
                             float* __restrict scratch /* 3*(n+1) */) {
    // row 0: free start; column 0: cumulative (as in sf_subsequence)
    for (int32_t j = 0; j < m; j++) cost[j] = fabsf(x[0] - y[j]);
    {
        float acc = cost[0];
        for (int32_t i = 1; i < n; i++) {
            acc += fabsf(x[i] - y[0]);
            cost[(int64_t)i * m] = acc;
        }
    }
    float* a2 = scratch;            // A_{d-2}
    float* a1 = scratch + (n + 1);  // A_{d-1}
    float* a0 = scratch + 2 * (n + 1);
    a2[0] = cost[0];                              // d = 0: (0,0)
    a1[0] = cost[1];                              // d = 1: (0,1)
    if (n > 1) a1[1] = cost[(int64_t)1 * m];      // d = 1: (1,0)
    for (int32_t d = 2; d <= n - 1 + m - 1; d++) {
        int32_t ilo = d - (m - 1);
        if (ilo < 1) ilo = 1;
        int32_t ihi = d - 1;
        if (ihi > n - 1) ihi = n - 1;
        if (d < m) a0[0] = cost[d];               // row 0 boundary
        for (int32_t i = ilo; i <= ihi; i++) {    // vectorizable
            float up = a1[i - 1];
            float left = a1[i];
            float dg = a2[i - 1];
            float mn = left;
            if (dg < mn) mn = dg;
            if (up < mn) mn = up;
            a0[i] = fabsf(x[i] - y[d - i]) + mn;
        }
        for (int32_t i = ilo; i <= ihi; i++)      // scatter to row-major
            cost[(int64_t)i * m + (d - i)] = a0[i];
        if (d <= n - 1) a0[d] = cost[(int64_t)d * m];  // column 0 boundary
        float* t = a2; a2 = a1; a1 = a0; a0 = t;
    }
}

// Anti-diagonal subsequence DP that emits only 1-byte DIRECTION codes
// (0=diag, 1=left, 2=up; the greedy backtracker's decision at each
// interior cell, ref path cdtw.c:134-147 tie order diag>left>up on
// float equality) instead of the full f32 cost matrix. The codes are
// computed from the identical f32 DP values the backtracker would
// compare (the diagonal carry buffers ARE those values), so the path
// is bit-identical to sf_path over the full matrix -- while the store
// traffic drops 4x (1 byte vs 4) and becomes CONTIGUOUS per diagonal
// (dirs[d*n + i]) instead of the row-major scatter whose stride-m
// stores touch one cache line each (the measured bottleneck of the
// full-matrix variant at RNA window sizes). Boundary cells need no
// codes: the backtracker moves unconditionally at i==0 (left) and
// j==0 (up).
static void subsequence_diag_dirs(const float* __restrict x, int32_t n,
                                  const float* __restrict y, int32_t m,
                                  uint8_t* __restrict dirs /* (n+m-1)*n */,
                                  float* __restrict scratch /* 3*(n+1) */,
                                  float* __restrict col0 /* n */) {
    // column 0 cumulative values (free start on the reference axis
    // applies to row 0 only; column 0 accumulates, sf_subsequence)
    {
        float acc = fabsf(x[0] - y[0]);
        col0[0] = acc;
        for (int32_t i = 1; i < n; i++) {
            acc += fabsf(x[i] - y[0]);
            col0[i] = acc;
        }
    }
    float* a2 = scratch;            // A_{d-2}
    float* a1 = scratch + (n + 1);  // A_{d-1}
    float* a0 = scratch + 2 * (n + 1);
    a2[0] = col0[0];                              // d = 0: (0,0)
    if (m > 1) a1[0] = fabsf(x[0] - y[1]);        // d = 1: (0,1)
    if (n > 1) a1[1] = col0[1];                   // d = 1: (1,0)
    for (int32_t d = 2; d <= n - 1 + m - 1; d++) {
        int32_t ilo = d - (m - 1);
        if (ilo < 1) ilo = 1;
        int32_t ihi = d - 1;
        if (ihi > n - 1) ihi = n - 1;
        if (d < m) a0[0] = fabsf(x[0] - y[d]);    // row 0 boundary
        uint8_t* __restrict drow = dirs + (int64_t)d * n;
        int32_t i = ilo;
#if defined(__AVX512F__)
        // 16 cells per iteration; cmp+blend chains mirror the scalar
        // `mn=left; if(dg<mn)...; if(up<mn)...` order exactly (min_ps
        // NaN semantics differ), EQ_OQ matches the == tie tests, and
        // _mm512_abs_ps is the same sign-bit clear as fabsf -- each
        // lane is the scalar computation, so results stay bit-exact.
        {
            const __m512i rev = _mm512_set_epi32(0, 1, 2, 3, 4, 5, 6, 7,
                                                 8, 9, 10, 11, 12, 13, 14, 15);
            const __m512i one = _mm512_set1_epi32(1);
            const __m512i two = _mm512_set1_epi32(2);
            for (; i + 15 <= ihi; i += 16) {
                __m512 up = _mm512_loadu_ps(a1 + i - 1);
                __m512 left = _mm512_loadu_ps(a1 + i);
                __m512 dg = _mm512_loadu_ps(a2 + i - 1);
                __m512 mn = _mm512_mask_mov_ps(
                    left, _mm512_cmp_ps_mask(dg, left, _CMP_LT_OQ), dg);
                mn = _mm512_mask_mov_ps(
                    mn, _mm512_cmp_ps_mask(up, mn, _CMP_LT_OQ), up);
                __mmask16 isdg = _mm512_cmp_ps_mask(dg, mn, _CMP_EQ_OQ);
                __mmask16 isleft = _mm512_cmp_ps_mask(left, mn, _CMP_EQ_OQ);
                __m512i c = _mm512_mask_mov_epi32(two, isleft, one);
                c = _mm512_maskz_mov_epi32(~isdg, c);
                _mm_storeu_si128((__m128i*)(drow + i),
                                 _mm512_cvtepi32_epi8(c));
                __m512 xv = _mm512_loadu_ps(x + i);
                // y[d-i-l] for lane l: reversed contiguous load
                __m512 yv = _mm512_permutexvar_ps(
                    rev, _mm512_loadu_ps(y + (d - i) - 15));
                __m512 local = _mm512_abs_ps(_mm512_sub_ps(xv, yv));
                _mm512_storeu_ps(a0 + i, _mm512_add_ps(local, mn));
            }
        }
#endif
        for (; i <= ihi; i++) {
            float up = a1[i - 1];
            float left = a1[i];
            float dg = a2[i - 1];
            float mn = left;
            if (dg < mn) mn = dg;
            if (up < mn) mn = up;
            drow[i] = (dg == mn) ? 0 : ((left == mn) ? 1 : 2);
            a0[i] = fabsf(x[i] - y[d - i]) + mn;
        }
        if (d <= n - 1) a0[d] = col0[d];          // column 0 boundary
        float* t = a2; a2 = a1; a1 = a0; a0 = t;
    }
}

// Last-row-only subsequence DP with O(m) memory (two alternating rows):
// the host CPU engine's scoring pass, same recurrence as sf_subsequence.
// Writes row n-1 into lastrow (m floats).
void sf_subsequence_lastrow(const float* __restrict x, int32_t n,
                            const float* __restrict y, int32_t m,
                            float* __restrict lastrow, float* scratch /* m */) {
    float* prev = scratch;
    float* cur = lastrow;
    for (int32_t j = 0; j < m; j++) prev[j] = fabsf(x[0] - y[j]);
    if (n == 1) {
        memcpy(lastrow, prev, sizeof(float) * m);
        return;
    }
    float col0 = prev[0];
    for (int32_t i = 1; i < n; i++) {
        const float xi = x[i];
        col0 += fabsf(xi - y[0]);
        cur[0] = col0;
        float up_acc = col0;
        for (int32_t j = 1; j < m; j++) {
            float mn = prev[j];
            if (prev[j - 1] < mn) mn = prev[j - 1];
            if (up_acc < mn) mn = up_acc;
            up_acc = fabsf(xi - y[j]) + mn;
            cur[j] = up_acc;
        }
        float* t = prev; prev = cur; cur = t;
    }
    if (prev != lastrow) memcpy(lastrow, prev, sizeof(float) * m);
}

// Last-row-only STANDARD DTW (boundary anchored) with O(m) memory:
// row 0 and column 0 are cumulative (ref std_dtw cdtw.c:70-94, used by
// --dtw-std where only the per-track corner cell becomes a candidate,
// sigfish.c:914-925). Exact scalar op order -- the lax.scan engine's
// prefix-min reformulation reassociates f32 adds and drifts by ulps,
// which flips printf digits on fuzzed inputs (seeds 3003/3031).
void sf_std_lastrow(const float* __restrict x, int32_t n,
                    const float* __restrict y, int32_t m,
                    float* __restrict lastrow, float* scratch /* m */) {
    float* prev = scratch;
    float* cur = lastrow;
    prev[0] = fabsf(x[0] - y[0]);
    for (int32_t j = 1; j < m; j++) prev[j] = fabsf(x[0] - y[j]) + prev[j - 1];
    if (n == 1) {
        memcpy(lastrow, prev, sizeof(float) * m);
        return;
    }
    float col0 = prev[0];
    for (int32_t i = 1; i < n; i++) {
        const float xi = x[i];
        col0 = fabsf(xi - y[0]) + col0;
        cur[0] = col0;
        float up_acc = col0;
        for (int32_t j = 1; j < m; j++) {
            float mn = prev[j];
            if (prev[j - 1] < mn) mn = prev[j - 1];
            if (up_acc < mn) mn = up_acc;
            up_acc = fabsf(xi - y[j]) + mn;
            cur[j] = up_acc;
        }
        float* t = prev; prev = cur; cur = t;
    }
    if (prev != lastrow) memcpy(lastrow, prev, sizeof(float) * m);
}

// Fused window recompute + backtrack (direction-code anti-diagonal DP
// for subsequence; full-matrix row-major for std and degenerate sizes).
// Returns the path length (px/py must hold n+m entries), or -1 on
// allocation failure.
int32_t sf_subsequence_backtrack(const float* x, int32_t n, const float* y,
                                 int32_t m, int32_t starty, int32_t use_std,
                                 int32_t* px, int32_t* py) {
    // per-thread growable scratch (reallocated once per top-5 candidate
    // otherwise -- page-fault churn)
    static thread_local float* cost = nullptr;
    static thread_local float* scratch = nullptr;
    static thread_local uint8_t* dirs = nullptr;
    static thread_local int64_t cost_cap = 0, scratch_cap = 0, dirs_cap = 0;
    int64_t need_scratch = 3 * (int64_t)(n + 1) + n;
    if (need_scratch > scratch_cap) {
        free(scratch);
        scratch = (float*)malloc(sizeof(float) * need_scratch);
        scratch_cap = scratch ? need_scratch : 0;
        if (!scratch) return -1;
    }
    if (!use_std && n >= 2 && m >= 2) {
        // direction-code route: no O(n*m) float matrix at all
        int64_t need_dirs = (int64_t)(n + m - 1) * n;
        if (need_dirs > dirs_cap) {
            free(dirs);
            dirs = (uint8_t*)malloc(need_dirs);
            dirs_cap = dirs ? need_dirs : 0;
            if (!dirs) return -1;
        }
        subsequence_diag_dirs(x, n, y, m, dirs, scratch,
                              scratch + 3 * (n + 1));
        int32_t i = n - 1, j = starty, k = 0;
        px[k] = i; py[k] = j; k++;
        while (i > 0 || j > 0) {
            if (i == 0) {
                j--;
            } else if (j == 0) {
                i--;
            } else {
                uint8_t c = dirs[(int64_t)(i + j) * n + i];
                if (c == 0) { i--; j--; }
                else if (c == 1) { j--; }
                else { i--; }
            }
            px[k] = i; py[k] = j; k++;
        }
        for (int32_t a = 0, b = k - 1; a < b; a++, b--) {
            int32_t t = px[a]; px[a] = px[b]; px[b] = t;
            t = py[a]; py[a] = py[b]; py[b] = t;
        }
        int32_t a_star = 0;
        for (int32_t p = 1; p < k; p++) {
            if (px[p] == 0) a_star++;
            else break;
        }
        if (a_star > 0) {
            memmove(px, px + a_star, sizeof(int32_t) * (k - a_star));
            memmove(py, py + a_star, sizeof(int32_t) * (k - a_star));
        }
        return k - a_star;
    }
    int64_t need_cost = (int64_t)n * m;
    if (need_cost > cost_cap) {
        free(cost);
        cost = (float*)malloc(sizeof(float) * need_cost);
        cost_cap = cost ? need_cost : 0;
        if (!cost) return -1;
    }
    if (use_std) sf_std_dtw(x, n, y, m, cost, 0);
    else sf_subsequence(x, n, y, m, cost);
    return sf_subsequence_path(cost, n, m, starty, px, py);
}

// ------------------------------------------------------------ zscore

// In-place population z-score with *sequential* float32 accumulation --
// the exact summation order of the reference (genref.c:23-47 for tracks,
// sigfish.c:483-502 for query slices). numpy's pairwise summation
// rounds differently on long tracks (29,898 events shifts the mean by
// ~1e-4), which was the source of %.2f-level score drift vs the C
// binary.
void sf_zscore(float* x, int64_t n) {
    if (n <= 0) return;
    float mean = 0.0f;
    for (int64_t j = 0; j < n; j++) mean += x[j];
    mean /= (float)n;
    float var = 0.0f;
    for (int64_t j = 0; j < n; j++) var += (x[j] - mean) * (x[j] - mean);
    var /= (float)n;
    float stdv = (float)sqrt((double)var);
    for (int64_t j = 0; j < n; j++) x[j] = (x[j] - mean) / stdv;
}

// Sequential-f32 mean, the reference's stat.h:17 meanf: the polyA band
// thresholds are m_a+30±20 with m_a computed this way, and a pairwise
// (numpy) summation can flip a borderline in-band sample.
float sf_meanf(const float* x, int64_t n) {
    float sum = 0.0f;
    for (int64_t j = 0; j < n; j++) sum += x[j];
    return sum / (float)n;
}

// ------------------------------------------------------------- events

// One sliding Welch t-stat pass: bit-exact with events.c:319-368 --
// the reference's float/double mixing is reproduced operation by
// operation (float divisions for the right window, float mean squares,
// double left-window terms), because a 1-ulp t-stat difference at a
// threshold flips an event boundary. Branchless + __restrict so the
// loop auto-vectorizes (IEEE div/sqrt are exact per lane, so
// vectorization preserves bit-exactness; note sums[i-w] is subtracted
// unconditionally -- sums[0] == 0.0 makes the i == w case identical to
// the reference's skipped subtraction).
static void sf_tstat_range(const double* __restrict sums,
                           const double* __restrict sumsqs,
                           int64_t i0, int64_t i1, int32_t w,
                           float* __restrict tst) {
    const float eta = FLT_MIN;
    const float w_lengthf = (float)w;
    for (int64_t i = i0; i <= i1; i++) {
        double sum1 = sums[i] - sums[i - w];
        double sumsq1 = sumsqs[i] - sumsqs[i - w];
        float sum2 = (float)(sums[i + w] - sums[i]);
        float sumsq2 = (float)(sumsqs[i + w] - sumsqs[i]);
        float mean1 = (float)(sum1 / w_lengthf);
        float mean2 = sum2 / w_lengthf;
        float combined_var = (float)(sumsq1 / w_lengthf -
                                     mean1 * mean1 +
                                     sumsq2 / w_lengthf -
                                     mean2 * mean2);
        combined_var = fmaxf(combined_var, eta);
        const float delta_mean = mean2 - mean1;
        tst[i] = (float)(fabs(delta_mean) /
                         sqrt(combined_var / w_lengthf));
    }
}

// Vectorized t-stat. Every operation of the scalar loop is a per-lane
// IEEE op (sub/div/mul/cvt/sqrt/abs/max in the same order and widths:
// f64 for the left window and the accumulation chain, f32 for the right
// window), so the 8-lane AVX-512 body is bit-identical to the scalar
// loop — verified lane-for-lane by tests/test_native.py. vmaxps keeps
// fmaxf's NaN semantics here (returns the second operand, eta, when the
// variance lane is NaN). Scalar tail for the remainder.
#if defined(__AVX512F__)
// one 8-lane t-stat evaluation at positions [i, i+8) for window w; the
// s_i/q_i central loads are shared by the dual-window caller
static inline __m256 sf_tstat_vec8(const double* __restrict sums,
                                   const double* __restrict sumsqs,
                                   int64_t i, int32_t w,
                                   __m512d s_i, __m512d q_i) {
    const float w_lengthf = (float)w;
    const __m512d wd = _mm512_set1_pd((double)w_lengthf);
    const __m256 wf = _mm256_set1_ps(w_lengthf);
    const __m256 eta = _mm256_set1_ps(FLT_MIN);
    __m512d s_l = _mm512_loadu_pd(sums + i - w);
    __m512d s_r = _mm512_loadu_pd(sums + i + w);
    __m512d q_l = _mm512_loadu_pd(sumsqs + i - w);
    __m512d q_r = _mm512_loadu_pd(sumsqs + i + w);
    __m512d sum1 = _mm512_sub_pd(s_i, s_l);
    __m512d sumsq1 = _mm512_sub_pd(q_i, q_l);
    __m256 sum2 = _mm512_cvtpd_ps(_mm512_sub_pd(s_r, s_i));
    __m256 sumsq2 = _mm512_cvtpd_ps(_mm512_sub_pd(q_r, q_i));
    __m256 mean1 = _mm512_cvtpd_ps(_mm512_div_pd(sum1, wd));
    __m256 mean2 = _mm256_div_ps(sum2, wf);
    // (((sumsq1/w)_f64 - (mean1*mean1)_f32) + (sumsq2/w)_f32) -
    // (mean2*mean2)_f32, accumulated in f64 exactly as the scalar
    // expression promotes
    __m512d acc = _mm512_div_pd(sumsq1, wd);
    acc = _mm512_sub_pd(acc, _mm512_cvtps_pd(_mm256_mul_ps(mean1, mean1)));
    acc = _mm512_add_pd(acc, _mm512_cvtps_pd(_mm256_div_ps(sumsq2, wf)));
    acc = _mm512_sub_pd(acc, _mm512_cvtps_pd(_mm256_mul_ps(mean2, mean2)));
    __m256 cv = _mm256_max_ps(_mm512_cvtpd_ps(acc), eta);
    __m256 delta = _mm256_sub_ps(mean2, mean1);
    __m512d denom = _mm512_sqrt_pd(_mm512_cvtps_pd(_mm256_div_ps(cv, wf)));
    __m512d absd = _mm512_abs_pd(_mm512_cvtps_pd(delta));
    return _mm512_cvtpd_ps(_mm512_div_pd(absd, denom));
}
#endif

static void sf_tstat_loop(const double* __restrict sums,
                          const double* __restrict sumsqs,
                          int64_t nsample, int32_t w,
                          float* __restrict tst) {
    int64_t i = w;
    const int64_t iend = nsample - w;  // inclusive
#if defined(__AVX512F__)
    for (; i + 7 <= iend; i += 8) {
        __m512d s_i = _mm512_loadu_pd(sums + i);
        __m512d q_i = _mm512_loadu_pd(sumsqs + i);
        _mm256_storeu_ps(tst + i,
                         sf_tstat_vec8(sums, sumsqs, i, w, s_i, q_i));
    }
#endif
    sf_tstat_range(sums, sumsqs, i, iend, w, tst);
}

// both detector windows in ONE streaming pass over sums/sumsqs: the
// t-stat is memory-bound (6 f64 streams per window), and the central
// loads are shared, so fusing halves the traffic. Per-lane operations
// are identical to sf_tstat_loop -- outputs are bit-identical.
// Requires w1 <= w2; covers tstat1 over [w1, n-w1] and tstat2 over
// [w2, n-w2] (the w1-only edges run scalar).
static void sf_tstat_dual(const double* __restrict sums,
                          const double* __restrict sumsqs,
                          int64_t nsample, int32_t w1, int32_t w2,
                          float* __restrict tst1,
                          float* __restrict tst2) {
    int64_t i = w2;
    const int64_t iend2 = nsample - w2;  // inclusive, window-2 range
#if defined(__AVX512F__)
    for (; i + 7 <= iend2; i += 8) {
        __m512d s_i = _mm512_loadu_pd(sums + i);
        __m512d q_i = _mm512_loadu_pd(sumsqs + i);
        _mm256_storeu_ps(tst1 + i,
                         sf_tstat_vec8(sums, sumsqs, i, w1, s_i, q_i));
        _mm256_storeu_ps(tst2 + i,
                         sf_tstat_vec8(sums, sumsqs, i, w2, s_i, q_i));
    }
#endif
    sf_tstat_range(sums, sumsqs, i, iend2, w1, tst1);
    sf_tstat_range(sums, sumsqs, i, iend2, w2, tst2);
    // window-1 edges outside the fused range
    if (w1 < w2) {
        sf_tstat_range(sums, sumsqs, w1, w2 - 1, w1, tst1);
        sf_tstat_range(sums, sumsqs, nsample - w2 + 1, nsample - w1, w1,
                       tst1);
    }
}

// t-test event segmentation, one call per read. Exact port of
// ops/events.py (itself validated against src/events.c semantics).
// Outputs sized <= nsample+1; returns the event count.
//
// exact_limit / n_safe_out support PREFIX-BOUNDED eventization: when the
// caller passes a truncated signal (sig = full[:S]), t-stats at
// positions > S - w2 differ from the full-signal run (their right
// window crosses the cut), so peak COMMITS at steps >= exact_limit
// (= S - w2) are unreliable. Commits at steps < exact_limit are
// bit-identical to the full run (the joint detector state at step i
// depends only on t-stats at steps <= i, all exact there), and commit
// order equals list order, so the safe peaks are a strict prefix.
// *n_safe_out = number of leading EVENTS whose closing peak committed
// before exact_limit -- those events (boundaries, mean, stdv) are
// bit-identical to the full-signal run's first events. Callers that
// pass the whole signal use exact_limit = nsample (the final
// to-nsample event is then also counted safe).
int32_t sf_detect_events(const float* sig, int64_t nsample,
                         int32_t w1, int32_t w2, float t1f, float t2f,
                         float peak_height,
                         int64_t* ev_start, float* ev_len,
                         float* ev_mean, float* ev_stdv,
                         int64_t exact_limit, int32_t* n_safe_out) {
    if (n_safe_out) *n_safe_out = 0;
    if (nsample <= 0) return 0;
    // per-thread growable scratch: a fresh multi-MB malloc/free pair per
    // read costs ~2 ns/sample in page faults at RNA read lengths
    static thread_local double* sums = nullptr;
    static thread_local double* sumsqs = nullptr;
    static thread_local float* tstat0 = nullptr;
    static thread_local float* tstat1 = nullptr;
    static thread_local int64_t* peaks = nullptr;
    static thread_local int64_t* commits = nullptr;
    static thread_local int64_t scratch_cap = 0;
    if (nsample + 1 > scratch_cap) {
        int64_t cap = nsample + 1;
        if (cap < 2 * scratch_cap) cap = 2 * scratch_cap;
        free(sums); free(sumsqs); free(tstat0); free(tstat1); free(peaks);
        free(commits);
        sums = (double*)malloc(sizeof(double) * cap);
        sumsqs = (double*)malloc(sizeof(double) * cap);
        tstat0 = (float*)malloc(sizeof(float) * cap);
        tstat1 = (float*)malloc(sizeof(float) * cap);
        peaks = (int64_t*)malloc(sizeof(int64_t) * cap);
        commits = (int64_t*)malloc(sizeof(int64_t) * cap);
        if (!sums || !sumsqs || !tstat0 || !tstat1 || !peaks || !commits) {
            free(sums); free(sumsqs); free(tstat0); free(tstat1);
            free(peaks); free(commits);
            sums = sumsqs = nullptr; tstat0 = tstat1 = nullptr;
            peaks = nullptr; commits = nullptr; scratch_cap = 0;
            return -1;
        }
        scratch_cap = cap;
    }
    float* tstat[2] = {tstat0, tstat1};
    // zero only what the detector reads (positions outside the computed
    // t-stat range stay 0, as with the original calloc)
    memset(tstat0, 0, sizeof(float) * nsample);
    memset(tstat1, 0, sizeof(float) * nsample);
    sums[0] = 0.0; sumsqs[0] = 0.0;
    for (int64_t i = 0; i < nsample; i++) {
        // events.c:303-305: the square is a FLOAT multiply (data[i] *
        // data[i] with float data), rounded to f32 BEFORE the double
        // add -- squaring in f64 flips t-stat boundaries (fuzz 1090)
        float f = sig[i];
        sums[i + 1] = sums[i] + (double)f;
        sumsqs[i + 1] = sumsqs[i] + (double)(f * f);
    }

    // two sliding Welch t-stats: bit-exact port of events.c:319-368;
    // fused single pass when both windows are active (the common case)
    if (w1 >= 2 && w2 >= w1 && nsample >= 2 * (int64_t)w2) {
        sf_tstat_dual(sums, sumsqs, nsample, w1, w2, tstat0, tstat1);
    } else {
        const int32_t ws[2] = {w1, w2};
        for (int p = 0; p < 2; p++) {
            if (nsample >= 2 * (int64_t)ws[p] && ws[p] >= 2)
                sf_tstat_loop(sums, sumsqs, nsample, ws[p], tstat[p]);
        }
    }

    // coupled short/long peak detector state machine
    // (exact port of ops/events.py:119-146 / events.c:375-447).
    //
    // The coupling is ONE-directional: the short detector (k=0) never
    // reads long-detector state; the long detector (k=1) consumes only
    // the reset+mask events the short one emits. Splitting the
    // interleaved per-sample dispatch into two single-detector passes
    // (pass A records det0's peaks and its per-sample mask schedule;
    // pass B replays the schedule) executes the identical state
    // transitions in the identical order -- the merged peak list is
    // bit-for-bit the interleaved loop's -- with tighter loops and a
    // wholesale skip of det1's masked stretches.
    static thread_local int64_t* mask_i = nullptr;   // trigger sample
    static thread_local int64_t* mask_to = nullptr;  // masked_to value
    static thread_local int64_t* p0i = nullptr;      // det0 commit sample
    static thread_local int64_t* p0v = nullptr;      // det0 peak pos
    static thread_local int64_t* p1i = nullptr;      // det1 commit sample
    static thread_local int64_t* p1v = nullptr;      // det1 peak pos
    static thread_local int64_t det_cap = 0;
    if (nsample + 1 > det_cap) {
        int64_t cap = nsample + 1;
        if (cap < 2 * det_cap) cap = 2 * det_cap;
        free(mask_i); free(mask_to);
        free(p0i); free(p0v); free(p1i); free(p1v);
        mask_i = (int64_t*)malloc(sizeof(int64_t) * cap);
        mask_to = (int64_t*)malloc(sizeof(int64_t) * cap);
        p0i = (int64_t*)malloc(sizeof(int64_t) * cap);
        p0v = (int64_t*)malloc(sizeof(int64_t) * cap);
        p1i = (int64_t*)malloc(sizeof(int64_t) * cap);
        p1v = (int64_t*)malloc(sizeof(int64_t) * cap);
        if (!mask_i || !mask_to || !p0i || !p0v || !p1i || !p1v) {
            free(mask_i); free(mask_to);
            free(p0i); free(p0v); free(p1i); free(p1v);
            mask_i = mask_to = p0i = p0v = p1i = p1v = nullptr;
            det_cap = 0;
            return -1;
        }
        det_cap = cap;
    }

    // pass A: short detector (never masked; masked_to starts at 0 and
    // sample 0 is skipped by `masked_to >= i`, reproduced here)
    int64_t nmask = 0, n0 = 0;
    {
        const float* s = tstat[0];
        const float thr = t1f;
        const int32_t wl = w1;
        int64_t peak_pos = -1;
        float peak_value = FLT_MAX;
        int32_t valid_peak = 0;
        for (int64_t i = 1; i < nsample; i++) {
            float v = s[i];
            if (peak_pos == -1) {
                if (v < peak_value) {
                    peak_value = v;
                } else if (v - peak_value > peak_height) {
                    peak_value = v;
                    peak_pos = i;
                }
            } else {
                if (v > peak_value) {
                    peak_value = v;
                    peak_pos = i;
                }
                if (peak_value > thr) {
                    mask_i[nmask] = i;
                    mask_to[nmask] = peak_pos + wl;
                    nmask++;
                }
                if (peak_value - v > peak_height && peak_value > thr) {
                    valid_peak = 1;
                }
                if (valid_peak && (i - peak_pos) > wl / 2) {
                    p0i[n0] = i;
                    p0v[n0] = peak_pos;
                    n0++;
                    peak_pos = -1;
                    peak_value = v;
                    valid_peak = 0;
                }
            }
        }
    }

    // pass B: long detector under the recorded mask schedule
    int64_t n1 = 0;
    {
        const float* s = tstat[1];
        const float thr = t2f;
        const int32_t wl = w2;
        int64_t masked_to = 0;
        int64_t peak_pos = -1;
        float peak_value = FLT_MAX;
        int32_t valid_peak = 0;
        int64_t mp = 0;
        for (int64_t i = 1; i < nsample; i++) {
            if (mp < nmask && mask_i[mp] == i) {
                masked_to = mask_to[mp];
                peak_pos = -1;
                peak_value = FLT_MAX;
                valid_peak = 0;
                mp++;
            }
            if (masked_to >= i) continue;
            float v = s[i];
            if (peak_pos == -1) {
                if (v < peak_value) {
                    peak_value = v;
                } else if (v - peak_value > peak_height) {
                    peak_value = v;
                    peak_pos = i;
                }
            } else {
                if (v > peak_value) {
                    peak_value = v;
                    peak_pos = i;
                }
                if (peak_value - v > peak_height && peak_value > thr) {
                    valid_peak = 1;
                }
                if (valid_peak && (i - peak_pos) > wl / 2) {
                    p1i[n1] = i;
                    p1v[n1] = peak_pos;
                    n1++;
                    peak_pos = -1;
                    peak_value = v;
                    valid_peak = 0;
                }
            }
        }
    }

    // merge by commit sample; at the same sample det0 commits first
    // (the interleaved loop's k order)
    int64_t npeak = 0;
    {
        int64_t a = 0, b = 0;
        while (a < n0 || b < n1) {
            if (b >= n1 || (a < n0 && p0i[a] <= p1i[b])) {
                commits[npeak] = p0i[a];
                peaks[npeak++] = p0v[a++];
            } else {
                commits[npeak] = p1i[b];
                peaks[npeak++] = p1v[b++];
            }
        }
    }

    // events from boundaries (events.c:461-508); keep peaks in
    // (0, nsample)
    int32_t nev = 0;
    int32_t n_safe = 0;
    int64_t start = 0;
    for (int64_t p = 0; p <= npeak; p++) {
        int64_t end = (p < npeak) ? peaks[p] : nsample;
        if (p < npeak && (end <= 0 || end >= nsample)) continue;
        // emit [start, end) -- zero-length events are kept, matching the
        // reference (create_events emits every boundary pair)
        float lenf = (float)(end - start);
        float mean = (float)(sums[end] - sums[start]) / lenf;
        float deltasqr = (float)(sumsqs[end] - sumsqs[start]);
        float var = deltasqr / lenf - mean * mean;
        if (var < 0.0f) var = 0.0f;
        ev_start[nev] = start;
        ev_len[nev] = lenf;
        ev_mean[nev] = mean;
        ev_stdv[nev] = sqrtf(var);
        nev++;
        // the closing peak's commit step decides prefix-exactness; the
        // final to-nsample event is safe only when the whole signal is
        // within the exact range (exact_limit >= nsample)
        if (p < npeak ? commits[p] < exact_limit : exact_limit >= nsample)
            n_safe = nev;
        start = end;
    }
    if (n_safe_out) *n_safe_out = n_safe;
    return nev;
}

// ADC -> picoamps in one vector pass: pa[i] = ((f32)sig[i] + (f32)offset)
// * ((f32)range / (f32)digitisation) -- the exact f32 op sequence of
// Slow5Record.to_pa (ref src/sigfish.c:344-347, src/misc.h:123), without
// numpy's intermediate temporaries.
void sf_pa_from_i16(const int16_t* sig, int64_t n, double digitisation,
                    double offset, double range, float* out) {
    const float off_f = (float)offset;
    const float unit = (float)range / (float)digitisation;
    for (int64_t i = 0; i < n; i++)
        out[i] = ((float)sig[i] + off_f) * unit;
}

// -------------------------------------------------------------- blow5

#if defined(__SSSE3__)
// streamvbyte shuffle tables: for each control byte, a pshufb mask that
// expands the 1..4-byte little-endian values of a 4-value group to four
// zero-extended u32 lanes, plus the group's total data length.
struct SvbTables {
    uint8_t shuf[256][16];
    uint8_t len[256];
    SvbTables() {
        for (int c = 0; c < 256; c++) {
            int pos = 0;
            for (int v = 0; v < 4; v++) {
                int nb = ((c >> (v * 2)) & 3) + 1;
                for (int b = 0; b < 4; b++)
                    shuf[c][v * 4 + b] =
                        (b < nb) ? (uint8_t)(pos + b) : 0xFF;
                pos += nb;
            }
            len[c] = (uint8_t)pos;
        }
    }
};
static const SvbTables& svb_tables() {
    static SvbTables t;  // C++11 magic static: thread-safe init
    return t;
}
#endif

// zstd decompression into a caller-provided thread-local growable
// buffer (system libzstd; lossless, any conforming decoder is exact).
// Returns the decompressed byte count, or -1 on error.
// ref: slow5lib/src/slow5_press.c:76-97 (record method 2) and the
// dev signal codes 250/251 (slow5_press.c:125-148).
static int64_t zstd_depress_tl(const uint8_t* src, int64_t src_len,
                               uint8_t** buf, size_t* buf_cap) {
#ifdef SF_NO_DEFLATE_ZSTD
    (void)src; (void)src_len; (void)buf; (void)buf_cap;
    return -1;
#else
    unsigned long long csz = ZSTD_getFrameContentSize(src, (size_t)src_len);
    size_t need;
    if (csz != ZSTD_CONTENTSIZE_UNKNOWN && csz != ZSTD_CONTENTSIZE_ERROR) {
        if (csz > (256ull << 20)) return -1;  // untrusted frame header
        need = (size_t)csz + 16;
    } else {
        // clamp the initial guess to the same 256 MB cap the growth
        // loop enforces: a crafted src_len must not drive a multi-GB
        // first malloc before the cap is ever consulted
        need = (size_t)src_len * 4 + 4096;
        if (need > (256u << 20)) need = (256u << 20);
    }
    while (true) {
        if (need > *buf_cap) {
            size_t cap = need < 2 * *buf_cap ? 2 * *buf_cap : need;
            // the 256 MB ceiling bounds the ALLOCATION too, not just the
            // retry loop: amortized doubling from a large live buffer
            // (e.g. 150 MB -> 300 MB) must not overshoot the advertised
            // cap (need itself never exceeds it by more than the +16)
            if (cap > (256ull << 20) && cap > need)
                cap = need > (256ull << 20) ? need : (256ull << 20);
            free(*buf);
            *buf = (uint8_t*)malloc(cap);
            *buf_cap = *buf ? cap : 0;
            if (!*buf) return -1;
        }
        size_t r = ZSTD_decompress(*buf, *buf_cap, src, (size_t)src_len);
        if (!ZSTD_isError(r)) return (int64_t)r;
        // growth-loop only when the frame header didn't carry a size
        // (then the only recoverable error is dst-too-small). 256 MB is
        // the HARD buffer ceiling on both paths: a declared size above
        // it is rejected up front, and an undeclared frame that still
        // fails at a full 256 MB buffer is rejected here -- the two
        // paths agree (previously the loop doubled past the cap once,
        // allocating up to 512 MB for undeclared frames)
        if (csz != ZSTD_CONTENTSIZE_UNKNOWN) return -1;
        if (need >= (256u << 20)) return -1;
        need *= 2;
        if (need > (256u << 20)) need = (256u << 20);
    }
#endif
}

// One BLOW5 record: optional zlib/zstd record decompression,
// fixed-column parse (slow5_defs.h:84-94 layout), optional signal
// decode: svb-zd (zigzag + delta + streamvbyte, slow5_press.c:1054-1140)
// or the whole-signal zlib/zstd dev codes.
// rec_press: 0 none, 1 zlib, 2 zstd. sig_press: 0 none, 1 svb-zd,
// 250 zlib, 251 zstd (slow5lib dev codes).
// Returns the signal length in samples, or -1 on error.
int64_t sf_blow5_decode(const uint8_t* blob, int64_t blob_len,
                        int32_t rec_press, int32_t sig_press,
                        char* read_id, int64_t read_id_cap,
                        uint32_t* read_group, double* meta4,
                        int16_t* signal_out, int64_t signal_cap) {
    const uint8_t* mem = blob;
    int64_t mem_len = blob_len;
    uint8_t* heap = nullptr;  // kept as a flag; buffer is thread-local
    if (rec_press == 1) {
#ifdef SF_NO_DEFLATE_ZSTD
        return -1;
#else
        // zlib-wrapped records decompressed with libdeflate (~3x faster
        // than zlib's inflate on this host; identical output bytes --
        // DEFLATE is lossless, any conforming decoder is exact).
        // Decompressor + output buffer are thread-local: a fresh
        // multi-MB malloc/free per record is page-fault churn.
        static thread_local struct libdeflate_decompressor* dec = nullptr;
        static thread_local uint8_t* buf = nullptr;
        static thread_local size_t buf_cap = 0;
        if (!dec) {
            dec = libdeflate_alloc_decompressor();
            if (!dec) return -1;
        }
        size_t need = (size_t)blob_len * 4 + 4096;
        // same 256 MB hard ceiling as the zstd path (initial guess,
        // doubling, and the retry loop below all respect it): a crafted
        // length prefix must not drive a multi-GB allocation
        if (need > (256u << 20)) need = (256u << 20);
        if (need > buf_cap) {
            size_t cap = need < 2 * buf_cap ? 2 * buf_cap : need;
            if (cap > (256u << 20)) cap = (256u << 20);
            free(buf);
            buf = (uint8_t*)malloc(cap);
            buf_cap = buf ? cap : 0;
            if (!buf) return -1;
        }
        while (true) {
            size_t dlen = 0;
            enum libdeflate_result rc = libdeflate_zlib_decompress(
                dec, blob, (size_t)blob_len, buf, buf_cap, &dlen);
            if (rc == LIBDEFLATE_SUCCESS) {
                mem = buf;
                mem_len = (int64_t)dlen;
                break;
            }
            if (rc == LIBDEFLATE_INSUFFICIENT_SPACE) {
                if (buf_cap >= (256u << 20)) return -1;  // hard ceiling
                size_t cap = buf_cap * 2;
                if (cap > (256u << 20)) cap = (256u << 20);
                free(buf);
                buf = (uint8_t*)malloc(cap);
                buf_cap = buf ? cap : 0;
                if (!buf) return -1;
                continue;
            }
            return -1;
        }
#endif
    } else if (rec_press == 2) {
        // zstd-wrapped records (slow5_press.c:76-97 method 2)
        static thread_local uint8_t* zbuf = nullptr;
        static thread_local size_t zbuf_cap = 0;
        int64_t dlen = zstd_depress_tl(blob, blob_len, &zbuf, &zbuf_cap);
        if (dlen < 0) return -1;
        mem = zbuf;
        mem_len = dlen;
    } else if (rec_press != 0) {
        return -1;
    }

    int64_t off = 0;
    if (mem_len < 2) { free(heap); return -1; }
    uint16_t rid_len;
    memcpy(&rid_len, mem + off, 2); off += 2;
    if (rid_len + 1 > read_id_cap || off + rid_len > mem_len) {
        free(heap); return -1;
    }
    memcpy(read_id, mem + off, rid_len);
    read_id[rid_len] = '\0';
    off += rid_len;
    if (off + 4 + 32 + 8 > mem_len) { free(heap); return -1; }
    memcpy(read_group, mem + off, 4); off += 4;
    memcpy(meta4, mem + off, 32); off += 32;  // digitisation,offset,range,rate
    uint64_t len_raw;
    memcpy(&len_raw, mem + off, 8); off += 8;

    // len_raw is UNTRUSTED: compare in unsigned arithmetic against the
    // remaining byte count -- casting to int64 first lets values >= 2^63
    // wrap negative and slip past the bounds checks (heap over-read).
    // Capacity misses return -2 - needed so the caller can retry ONCE
    // with the exact size instead of growth-looping on corrupt input.
    int64_t n = -1;
    if (sig_press == 0) {
        if (len_raw > (1ull << 61) ||  /* first: u64 wrap guard for *2 */
            len_raw * 2 > (uint64_t)(mem_len - off)) {
            free(heap); return -1;
        }
        n = (int64_t)len_raw;
        if (n > signal_cap) { free(heap); return -2 - n; }
        memcpy(signal_out, mem + off, (size_t)n * 2);
    } else if (sig_press == 1) {
        // len_raw is the BYTE count of the compressed blob (slow5.c:2880)
        if (len_raw < 4 || len_raw > (uint64_t)(mem_len - off)) {
            free(heap); return -1;
        }
        const uint8_t* sv = mem + off;
        uint32_t count;
        memcpy(&count, sv, 4);
        if ((int64_t)count > signal_cap) { free(heap); return -2 - (int64_t)count; }
        int64_t nctrl = ((int64_t)count + 3) / 4;
        // the whole control region must sit inside the blob BEFORE any
        // ctrl[i>>2] read: the per-value check below only bounds the
        // data pointer, and a crafted count with a short blob would
        // otherwise read past the caller's buffer
        if (4 + nctrl > (int64_t)len_raw) { free(heap); return -1; }
        const uint8_t* ctrl = sv + 4;
        const uint8_t* data = sv + 4 + nctrl;
        const uint8_t* dend = sv + len_raw;
        int32_t prev = 0;
        int64_t i = 0;
#if defined(__SSSE3__)
        // SIMD fast path: expand a 4-value group with one pshufb, then
        // zigzag + in-register prefix sum. Integer ops — results are
        // identical to the scalar loop bit for bit; the scalar tail
        // below finishes the remainder (and keeps the strict per-value
        // bounds check for truncated streams).
        {
            const SvbTables& tb = svb_tables();
            const __m128i one = _mm_set1_epi32(1);
            const __m128i zero = _mm_setzero_si128();
            // low 16 bits of each u32 lane -> four i16 (C cast truncates)
            const __m128i pack16 = _mm_setr_epi8(
                0, 1, 4, 5, 8, 9, 12, 13,
                (char)0x80, (char)0x80, (char)0x80, (char)0x80,
                (char)0x80, (char)0x80, (char)0x80, (char)0x80);
            __m128i prevv = _mm_setzero_si128();
            while (i + 4 <= (int64_t)count && data + 16 <= dend) {
                uint8_t c = ctrl[i >> 2];
                __m128i raw = _mm_loadu_si128((const __m128i*)data);
                __m128i zz = _mm_shuffle_epi8(
                    raw, _mm_loadu_si128((const __m128i*)tb.shuf[c]));
                __m128i d = _mm_xor_si128(
                    _mm_srli_epi32(zz, 1),
                    _mm_sub_epi32(zero, _mm_and_si128(zz, one)));
                d = _mm_add_epi32(d, _mm_slli_si128(d, 4));
                d = _mm_add_epi32(d, _mm_slli_si128(d, 8));
                __m128i s = _mm_add_epi32(d, prevv);
                _mm_storel_epi64((__m128i*)(signal_out + i),
                                 _mm_shuffle_epi8(s, pack16));
                prevv = _mm_shuffle_epi32(s, _MM_SHUFFLE(3, 3, 3, 3));
                data += tb.len[c];
                i += 4;
            }
            prev = _mm_cvtsi128_si32(prevv);
        }
#endif
        for (; i < (int64_t)count; i++) {
            uint32_t code = (ctrl[i >> 2] >> ((i & 3) * 2)) & 0x3;
            uint32_t nb = code + 1;
            if (data + nb > dend) { free(heap); return -1; }
            uint32_t zz = 0;
            memcpy(&zz, data, nb);  // little-endian partial load
            data += nb;
            int32_t d = (int32_t)(zz >> 1) ^ -(int32_t)(zz & 1);
            prev += d;
            signal_out[i] = (int16_t)prev;
        }
        n = (int64_t)count;
    } else if (sig_press == 250 || sig_press == 251) {
        // dev codes: the whole i16 signal zlib/zstd-compressed
        // (slow5_press.c:125-148); len_raw is the compressed byte count
        if (len_raw > (uint64_t)(mem_len - off)) { free(heap); return -1; }
        static thread_local uint8_t* sbuf = nullptr;
        static thread_local size_t sbuf_cap = 0;
        int64_t dlen;
        if (sig_press == 251) {
            dlen = zstd_depress_tl(mem + off, (int64_t)len_raw, &sbuf, &sbuf_cap);
        } else {
#ifdef SF_NO_DEFLATE_ZSTD
            free(heap);
            return -1;
#else
            static thread_local struct libdeflate_decompressor* sdec = nullptr;
            if (!sdec) {
                sdec = libdeflate_alloc_decompressor();
                if (!sdec) { free(heap); return -1; }
            }
            // initial guess clamped to the growth loop's 256 MB cap
            // (untrusted len_raw must not force a multi-GB first malloc)
            size_t need = (size_t)len_raw * 4 + 4096;
            if (need > (256u << 20)) need = (256u << 20);
            dlen = -1;
            while (true) {
                if (need > sbuf_cap) {
                    size_t cap = need < 2 * sbuf_cap ? 2 * sbuf_cap : need;
                    free(sbuf);
                    sbuf = (uint8_t*)malloc(cap);
                    sbuf_cap = sbuf ? cap : 0;
                    if (!sbuf) { free(heap); return -1; }
                }
                size_t got = 0;
                enum libdeflate_result rc = libdeflate_zlib_decompress(
                    sdec, mem + off, (size_t)len_raw, sbuf, sbuf_cap, &got);
                if (rc == LIBDEFLATE_SUCCESS) { dlen = (int64_t)got; break; }
                // 256 MB is the HARD ceiling: still-too-small at a full
                // 256 MB buffer fails (the doubling is clamped so the
                // allocation never exceeds the cap it advertises)
                if (rc == LIBDEFLATE_INSUFFICIENT_SPACE &&
                    need < (256u << 20)) {
                    need *= 2;
                    if (need > (256u << 20)) need = (256u << 20);
                    continue;
                }
                free(heap);
                return -1;
            }
#endif
        }
        if (dlen < 0 || (dlen & 1)) { free(heap); return -1; }
        n = dlen / 2;
        if (n > signal_cap) { free(heap); return -2 - n; }
        memcpy(signal_out, sbuf, (size_t)dlen);
    } else {
        free(heap);
        return -1;
    }
    free(heap);
    return n;
}

// ---------------------------------------------------------------- jnn

// Full jnnv2 adaptor finder: bit-exact port of jnn.c:100-180 including
// the reference's float arithmetic -- outlier clamp to [0,1200]
// (jnn.c:62-77), rolling mean via an f32 *running* accumulator
// (jnn.c:21-57; a cumsum would round differently over 40k samples),
// sequential-f32 mean/std of the trace (stat.h:17-44), threshold
// mean - std*scale, segment merge within seg_dist, [lo,hi] length
// filter, +window/2-1 offset. Writes (x, y) into out[0..1]; (-1,-1)
// when nsample <= window, (0,0) when nothing qualifies.
void sf_jnnv2(const int16_t* sig, int64_t nsample, int64_t window,
              float std_scale, int64_t seg_dist, int64_t hi_thresh,
              int64_t lo_thresh, int64_t* out) {
    if (nsample <= window) {
        out[0] = -1; out[1] = -1;
        return;
    }
    const float OUT_MAX = 1200.0f, OUT_MIN = 0.0f;
    int64_t tn = nsample - window;
    // thread-local scratch: clamped copy + rolling-mean trace
    static thread_local float* c = nullptr;
    static thread_local float* t = nullptr;
    static thread_local int64_t jv_cap = 0;
    if (nsample > jv_cap) {
        int64_t cap = nsample;
        if (cap < 2 * jv_cap) cap = 2 * jv_cap;
        free(c); free(t);
        c = (float*)malloc(sizeof(float) * cap);
        t = (float*)malloc(sizeof(float) * cap);
        if (!c || !t) {
            free(c); free(t); c = t = nullptr; jv_cap = 0;
            out[0] = -1; out[1] = -1; return;
        }
        jv_cap = cap;
    }
    // clamp pass first (branchless, auto-vectorizes): the sequential
    // running-sum chain below then runs on plain f32 loads. The clamp
    // value per sample is identical to inlining it, so the chain's
    // rounding sequence is unchanged (bit-exact with jnn.c:62-77 +
    // :21-57).
    for (int64_t i = 0; i < nsample; i++) {
        float v = (float)sig[i];
        v = v > OUT_MAX ? OUT_MAX : v;
        v = v < OUT_MIN ? OUT_MIN : v;
        c[i] = v;
    }
    // exact running-sum rolling mean (latency-bound f32 chain; order
    // fixed by bit-exactness, ref jnn.c:21-57)
    float tt = 0.0f;
    const float wf = (float)window;
    for (int64_t i = 0; i < window; i++) tt += c[i];
    t[0] = tt / wf;
    for (int64_t i = 1; i < tn; i++) {
        tt -= c[i - 1];
        tt += c[i + window - 1];
        t[i] = tt / wf;
    }
    float sum = 0.0f;
    for (int64_t i = 0; i < tn; i++) sum += t[i];
    float mn = sum / tn;
    float vs = 0.0f;
    for (int64_t i = 0; i < tn; i++) vs += (t[i] - mn) * (t[i] - mn);
    float std = sqrtf(vs / tn);
    float bot = mn - std * std_scale;

    int64_t cap = 256, nseg = 0;
    int64_t* segs = (int64_t*)malloc(sizeof(int64_t) * 2 * cap);
    if (!segs) { out[0] = -1; out[1] = -1; return; }
    int begin = 0;
    int64_t start = 0, end = 0;
    for (int64_t j = 0; j < tn; j++) {
        float v = t[j];
        if (v < bot && !begin) {
            start = j;
            begin = 1;
        } else if (v < bot) {
            end = j;
        } else if (v > bot && begin) {
            if (nseg && start - segs[2 * (nseg - 1) + 1] < seg_dist) {
                segs[2 * (nseg - 1) + 1] = end;
            } else {
                if (nseg >= cap) {
                    cap *= 2;
                    int64_t* ns =
                        (int64_t*)realloc(segs, sizeof(int64_t) * 2 * cap);
                    if (!ns) { free(segs); out[0]=-1; out[1]=-1; return; }
                    segs = ns;
                }
                segs[2 * nseg] = start;
                segs[2 * nseg + 1] = end;
                nseg++;
            }
            start = 0;
            end = 0;
            begin = 0;
        }
    }
    out[0] = 0; out[1] = 0;
    for (int64_t i = 0; i < nseg; i++) {
        int64_t a = segs[2 * i], b = segs[2 * i + 1];
        if (b - a > hi_thresh || b - a < lo_thresh) continue;
        out[0] = a + window / 2 - 1;
        out[1] = b + window / 2 - 1;
        break;
    }
    free(segs);
}

// Segment extractor over a below-threshold mask of the rolling-mean
// trace (adaptor finder inner loop). Exact port of jnn.c:126-152 (merge
// segments closer than seg_dist; the close condition is the strict
// `i > bot && begin` -- exact-equality samples leave the segment open).
// out holds (start, end) pairs; returns segment count, or -1 when cap
// is too small (caller retries with a larger buffer, mirroring the
// reference's realloc growth at jnn.c:141-145).
int64_t sf_jnn_segments(const double* t, int64_t n, double bot,
                        int64_t seg_dist, int64_t* out, int64_t cap) {
    int64_t nseg = 0;
    bool begin = false;
    int64_t start = 0, end = 0;
    for (int64_t j = 0; j < n; j++) {
        double v = t[j];
        if (v < bot && !begin) {
            start = j;
            begin = true;
        } else if (v < bot) {
            end = j;
        } else if (v > bot && begin) {
            if (nseg > 0 && start - out[2 * (nseg - 1) + 1] < seg_dist) {
                out[2 * (nseg - 1) + 1] = end;
            } else {
                if (nseg >= cap) return -1;
                out[2 * nseg] = start;
                out[2 * nseg + 1] = end;
                nseg++;
            }
            start = 0;
            end = 0;
            begin = false;
        }
    }
    return nseg;
}

// Error-tolerant in-range run detector. Exact port of ops/jnn.py
// jnn_core (jnn.c:191-279, SquiggleKit-derived).
//
// first_only: stop scanning as soon as segs[0] is FINAL -- i.e. no
// future sample can change it. A later run can only modify segs[0] by
// merging into it, which requires the run to START before
// segs[0].end + seg_dist (the merge test uses the run's start). So
// segs[0] is final once (a) a second segment has been appended (merges
// only ever touch the last segment), or (b) the scan position has
// passed segs[0].end + seg_dist with no active run that started inside
// that window. find_polya wants exactly segs[0] (jnn.c:354-376), and
// the polyA tail sits near the front of the read -- stopping there
// skips the O(read) tail scan. *finalized_out reports whether the
// early-stop proof fired (0 = ran to the end of the given array; the
// result is then exact only if the array was the whole signal).
int64_t sf_jnn_core(const double* sig, int64_t n, double top, double bot,
                    int64_t corrector, int64_t seg_dist, int64_t window,
                    double stall_len, int64_t error,
                    int64_t* out, int64_t cap,
                    int32_t first_only, int32_t* finalized_out) {
    bool prev = false;
    int64_t err = 0, prev_err = 0, c = 0;
    int64_t w = corrector;
    int64_t start = 0;
    int64_t nseg = 0;
    if (finalized_out) *finalized_out = 0;
    for (int64_t i = 0; i < n; i++) {
        bool in_range = sig[i] < top && sig[i] > bot;
        if (in_range) {
            if (!prev) {
                start = i;
                prev = true;
            }
            c += 1;
            w += 1;
            if (prev_err) prev_err = 0;
            if (c >= window && c >= w && (c % w) == 0) err -= 1;
        } else {
            if (prev && err < error) {
                c += 1;
                err += 1;
                prev_err += 1;
                if (c >= window && c >= w && (c % w) == 0) err -= 1;
            } else if (prev && (c >= window ||
                                (nseg == 0 &&
                                 (double)c >= (double)window * stall_len))) {
                int64_t end = i - prev_err;
                prev = false;
                if (nseg > 0 && start - out[2 * (nseg - 1) + 1] < seg_dist) {
                    out[2 * (nseg - 1) + 1] = end;
                } else {
                    if (nseg >= cap) return -1;  // caller retries larger
                    out[2 * nseg] = start;
                    out[2 * nseg + 1] = end;
                    nseg++;
                }
                c = 0;
                err = 0;
                prev_err = 0;
            } else if (prev) {
                prev = false;
                c = 0;
                err = 0;
                prev_err = 0;
            }
        }
        if (first_only && nseg >= 1) {
            if (nseg >= 2 ||
                (i >= out[1] + seg_dist &&
                 (!prev || start >= out[1] + seg_dist))) {
                if (finalized_out) *finalized_out = 1;
                return nseg;
            }
        }
    }
    return nseg;
}

}  // extern "C"
