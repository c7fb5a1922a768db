"""Adaptor / polyA segmentation for direct-RNA query-start autodetection.

ref: sigfish src/jnn.c, src/jnn.h
  - jnnv2 adaptor finder (jnn.c:100-180): outlier clamp to [0, 1200]
    (jnn.c:18-19), rolling mean window 2000, threshold mean - scale*std,
    segment merge within seg_dist, [lo_thresh, hi_thresh] length filter,
    +window/2-1 offset on the accepted segment.
  - jnn_core error-tolerant in-range run detector (jnn.c:191-279),
    SquiggleKit-derived; used for polyA with absolute band top/bot.
  - find_adaptor (jnn.c:182-189) runs jnnv2 on the RAW int16 signal;
    find_polya (jnn.c:354-376) runs jnn_core on pA floats.
  - detect_query_start (src/sigfish.c:380-422): adaptor -> mean of adaptor
    current -> polyA band mean+30+/-20 -> first event at/after polyA end.

Parameters ref src/jnn.h:30-99.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OUTLIER_MAX = 1200.0
OUTLIER_MIN = 0.0


@dataclass(frozen=True)
class JnnV2Param:
    std_scale: float
    seg_dist: int
    window: int
    hi_thresh: int
    lo_thresh: int


@dataclass(frozen=True)
class JnnParam:
    std_scale: float
    corrector: int
    seg_dist: int
    window: int
    stall_len: float
    error: int
    top: float = 0.0
    bot: float = 0.0


# ref jnn.h:85-99
JNNV2_RNA_R9_ADAPTOR = JnnV2Param(std_scale=0.5, seg_dist=1500, window=2000, hi_thresh=200000, lo_thresh=2000)
JNNV2_RNA_RNA004_ADAPTOR = JnnV2Param(std_scale=0.7, seg_dist=1500, window=2000, hi_thresh=200000, lo_thresh=500)
# ref jnn.h:53-73
JNNV1_R9_POLYA = JnnParam(std_scale=-1, corrector=50, seg_dist=200, window=250, stall_len=1.0, error=30)
JNNV1_RNA004_POLYA = JnnParam(std_scale=-1, corrector=50, seg_dist=200, window=250, stall_len=1.0, error=30)

PORE_R9 = 0
PORE_R10 = 1
PORE_RNA004 = 2


def _meanf(x: np.ndarray) -> float:
    """Sequential-f32 mean, exactly the reference's stat.h:17 meanf.

    numpy's np.mean uses pairwise summation, which rounds differently;
    m_a feeds the hard polyA band (m_a+30±20, sigfish.c:388-396), so a
    1-ulp shift can flip a borderline sample in or out of the band."""
    from .. import native

    m = native.meanf_seq(x)
    if m is not None:
        return m
    s = np.float32(0.0)
    for v in x.astype(np.float32):
        s += v
    return float(s / np.float32(len(x)))


def _rm_outlier(x: np.ndarray) -> np.ndarray:
    # == np.clip(x, MIN, MAX) (clip is max-then-min for MIN <= MAX) but
    # in-place on the one f64 copy -- np.clip's ufunc wrapper showed up
    # in the RNA host profile at 512 calls/batch
    y = x.astype(np.float64)
    np.maximum(y, OUTLIER_MIN, out=y)
    np.minimum(y, OUTLIER_MAX, out=y)
    return y


def _rolling_mean(x: np.ndarray, w: int) -> np.ndarray:
    """Mean of x[i:i+w] for i in [0, n-w). ref jnn.c:21-57 (running sum).

    Computed via float64 cumsum (the reference uses a float32 running
    accumulator; drift is < 1e-2 in t-units -- documented deviation).
    """
    c = np.zeros(x.size + 1, dtype=np.float64)
    np.cumsum(x, out=c[1:])
    return (c[w:] - c[: x.size - w + 1])[: x.size - w] / w


def jnnv2(sig_raw: np.ndarray, param: JnnV2Param) -> tuple[int, int]:
    """Adaptor segment finder on raw ADC samples. ref jnn.c:100-180.

    Returns (x, y) raw-sample pair; (0, 0) when nothing found, (-1, -1)
    when the signal is shorter than the rolling window.
    """
    n = sig_raw.size
    if n <= param.window:
        return (-1, -1)
    from .. import native

    if sig_raw.dtype == np.int16:
        res = native.jnnv2(
            sig_raw, param.window, param.std_scale, param.seg_dist,
            param.hi_thresh, param.lo_thresh,
        )
        if res is not None:
            return res
    t = _rolling_mean(_rm_outlier(sig_raw), param.window)
    mn = float(np.mean(t))
    std = float(np.std(t))
    bot = mn - std * param.std_scale

    nat_segs = native.jnn_segments(t, bot, param.seg_dist)
    if nat_segs is not None:
        segs = [[int(a), int(b)] for a, b in nat_segs]
    else:
        below = t < bot
        above = t > bot  # jnn.c:136 closes on the STRICT i > bot test;
        segs = []        # exact-equality samples leave the segment open
        begin = False
        start = 0
        end = 0
        for j in range(t.size):
            if below[j] and not begin:
                start = j
                begin = True
            elif below[j]:
                end = j
            elif above[j] and begin:
                if segs and start - segs[-1][1] < param.seg_dist:
                    segs[-1][1] = end
                else:
                    segs.append([start, end])
                start = 0
                end = 0
                begin = False

    for a, b in segs:
        if b - a > param.hi_thresh or b - a < param.lo_thresh:
            continue
        return (a + param.window // 2 - 1, b + param.window // 2 - 1)
    return (0, 0)


def jnn_core(
    sig: np.ndarray, param: JnnParam, first_only: bool = False
) -> list[tuple[int, int]] | tuple[list[tuple[int, int]], bool]:
    """Error-tolerant in-range run detector. Exact port of jnn.c:191-279.

    first_only: stop as soon as segs[0] is provably FINAL -- later
    samples can only alter segs[0] by merging into it, which requires a
    run STARTING before segs[0].end + seg_dist (the merge test uses the
    run's start, jnn.c:252), so finality holds once a second segment
    exists (merges only touch the last segment) or the scan passed
    segs[0].end + seg_dist with no active run started inside that
    window. Returns (segments, finalized); finalized=False = hit the
    end of `sig` without the proof firing (exact only if `sig` was the
    whole signal). Used by find_polya's bounded scan.
    """
    if param.std_scale > 0:
        mn = float(np.mean(sig))
        std = float(np.std(sig))
        top = mn + std * param.std_scale
        bot = mn - std * param.std_scale
    else:
        top = param.top
        bot = param.bot

    from .. import native

    nat_segs = native.jnn_core_segments(
        sig, top, bot, param.corrector, param.seg_dist, param.window,
        param.stall_len, param.error, first_only=first_only,
    )
    if nat_segs is not None:
        if first_only:
            segs_arr, finalized = nat_segs
            return [(int(a), int(b)) for a, b in segs_arr], finalized
        return [(int(a), int(b)) for a, b in nat_segs]

    prev = False
    err = 0
    prev_err = 0
    c = 0
    w = param.corrector
    seg_dist = param.seg_dist
    start = 0
    window = param.window
    error = param.error
    stall_len = param.stall_len

    segs: list[list[int]] = []
    finalized = False
    in_range = (sig < top) & (sig > bot)
    for i in range(sig.size):
        if in_range[i]:
            if not prev:
                start = i
                prev = True
            c += 1
            w += 1
            if prev_err:
                prev_err = 0
            if c >= window and c >= w and not (c % w):
                err -= 1
        else:
            if prev and err < error:
                c += 1
                err += 1
                prev_err += 1
                if c >= window and c >= w and not (c % w):
                    err -= 1
            elif prev and (c >= window or (not segs and c >= window * stall_len)):
                end = i - prev_err
                prev = False
                if segs and start - segs[-1][1] < seg_dist:
                    segs[-1][1] = end
                else:
                    segs.append([start, end])
                c = 0
                err = 0
                prev_err = 0
            elif prev:
                prev = False
                c = 0
                err = 0
                prev_err = 0
        if first_only and segs:
            if len(segs) >= 2 or (
                i >= segs[0][1] + seg_dist
                and (not prev or start >= segs[0][1] + seg_dist)
            ):
                finalized = True
                break
    out = [(a, b) for a, b in segs]
    return (out, finalized) if first_only else out


def find_adaptor(raw_signal: np.ndarray, pore: int = PORE_R9) -> tuple[int, int]:
    """ref jnn.c:182-189 (operates on the raw int16 samples)."""
    param = JNNV2_RNA_RNA004_ADAPTOR if pore == PORE_RNA004 else JNNV2_RNA_R9_ADAPTOR
    return jnnv2(raw_signal, param)


def find_polya(signal_pa: np.ndarray, top: float, bot: float, pore: int = PORE_R9) -> tuple[int, int]:
    """ref jnn.c:354-376 (first qualifying segment, absolute band).

    The reference scans the whole tail then takes segs[0]; the polyA
    sits right after the adaptor near the front of the read, so this
    runs jnn_core in first_only mode over geometrically growing
    prefixes -- the scanner stops the moment segs[0] is provably final
    (identical result, O(polyA region) instead of O(read))."""
    param = JNNV1_RNA004_POLYA if pore == PORE_RNA004 else JNNV1_R9_POLYA
    param = JnnParam(
        std_scale=param.std_scale,
        corrector=param.corrector,
        seg_dist=param.seg_dist,
        window=param.window,
        stall_len=param.stall_len,
        error=param.error,
        top=top,
        bot=bot,
    )
    n = signal_pa.size
    t = min(n, 8192)
    while True:
        segs, finalized = jnn_core(_rm_outlier(signal_pa[:t]), param, first_only=True)
        if finalized or t >= n:
            break
        t = min(n, t * 4)
    if segs:
        return segs[0]
    return (-1, -1)


def detect_polya_end(
    raw_signal: np.ndarray, signal_pa: np.ndarray, pore: int = PORE_R9
) -> int:
    """Raw-sample index of the polyA tail end (RNA, -p -1), or -1.

    The raw-signal half of detect_query_start (ref src/sigfish.c:380-404):
    adaptor segment -> mean adaptor current -> polyA band mean+30±20.
    Split out so the pipeline's prefix-bounded eventization can find the
    polyA BEFORE deciding how many samples to eventize."""
    ax, ay = find_adaptor(raw_signal, pore)
    n = raw_signal.size
    if ay <= 0:
        return -1
    assert ay < n
    m_a = _meanf(signal_pa[ax:ay].astype(np.float32))
    px, py = find_polya(signal_pa[ay:], m_a + 30 + 20, m_a + 30 - 20, pore)
    if py <= 0:
        return -1
    return py + ay


def detect_query_start(
    raw_signal: np.ndarray,
    signal_pa: np.ndarray,
    event_starts: np.ndarray,
    pore: int = PORE_R9,
) -> int:
    """Autodetect the first query event after the polyA tail (RNA, -p -1).

    ref src/sigfish.c:380-422. Returns -1 on failure.
    """
    py = detect_polya_end(raw_signal, signal_pa, pore)
    if py < 0:
        return -1
    # first event with start >= py: LINEAR first-match like the
    # reference's while loop (sigfish.c:405-407) -- equivalent to a
    # binary search only on sorted tables, so match the scan exactly
    ge = np.nonzero(event_starts.astype(np.int64) >= py)[0]
    if ge.size == 0:
        return -1
    return int(ge[0])
