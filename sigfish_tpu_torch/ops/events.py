"""Event segmentation of raw nanopore current (t-test change-point detector).

Numpy implementation of the scrappie-derived detector used by sigfish:
two sliding-window Welch t-statistics (short + long window) feed a coupled
peak detector whose firing positions are event boundaries; each event gets
(start, length, mean, stdv) from prefix sums.

ref: sigfish src/events.c
  - parameters: DNA w=(3,6) thr=(1.4,9.0) peak=0.2 (events.c:47-51),
    RNA w=(7,14) thr=(2.5,9.0) peak=1.0 (events.c:53-58)
  - prefix sums in double (events.c:297-307)
  - t-stat loop (events.c:319-368); boundary entries zeroed
  - short/long peak detector state machine (events.c:375-447)
  - event construction (events.c:461-508)
  - NOTE: raw-signal MAD trimming is dead code in the reference --
    trim_and_segment_raw's return value is discarded and detect_events runs
    on the full signal (events.c:557-576). Replicated by not trimming.

The t-stat arrays are computed vectorized in float64 and cast to float32;
the reference mixes float/double in the combined-variance expression, so
values can differ by ~1 ulp (documented deviation -- boundary flips are
possible only for t-stats within 1 ulp of a threshold).

The peak-detector state machine is inherently sequential; a numpy
implementation is provided here as the readable reference, and a C++
implementation (csrc/) is used by the production pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# detector parameters, ref events.c:47-58
DNA_PARAMS = dict(window_length1=3, window_length2=6, threshold1=1.4, threshold2=9.0, peak_height=0.2)
RNA_PARAMS = dict(window_length1=7, window_length2=14, threshold1=2.5, threshold2=9.0, peak_height=1.0)


@dataclass
class EventTable:
    start: np.ndarray   # uint64 raw-signal index of event start
    length: np.ndarray  # float32 number of samples
    mean: np.ndarray    # float32 mean current (pA)
    stdv: np.ndarray    # float32

    @property
    def n(self) -> int:
        return int(self.start.size)


def compute_prefix_sums(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative sum / sum-of-squares, element i excludes data[i].

    ref: events.c:297-307 (double accumulators over float data). NOTE
    the square `data[i] * data[i]` is a FLOAT multiply in the reference
    (rounded to f32 before the double add) -- squaring in f64 shifts
    sumsq by ulps, which cancellation in the variance terms amplifies
    into wrong stdv values and occasional t-stat boundary flips (found
    by differential fuzzing, seed 1090).
    """
    d32 = data.astype(np.float32)
    sums = np.zeros(d32.size + 1, dtype=np.float64)
    sumsqs = np.zeros(d32.size + 1, dtype=np.float64)
    np.cumsum(d32.astype(np.float64), out=sums[1:])
    np.cumsum((d32 * d32).astype(np.float64), out=sumsqs[1:])
    return sums, sumsqs


def compute_tstat(sums: np.ndarray, sumsqs: np.ndarray, d_length: int, w: int) -> np.ndarray:
    """Windowed two-sample t-statistic, bit-exact with events.c:319-368.

    The reference mixes float and double operation by operation (the
    right-window sums and their divisions are float, the left-window
    terms double, the mean squares float); each step here reproduces
    that exact rounding -- a 1-ulp t-stat difference at a threshold
    moves an event boundary.
    """
    tstat = np.zeros(d_length, dtype=np.float32)
    if d_length < 2 * w or w < 2:
        return tstat
    eta = np.float32(np.finfo(np.float32).tiny)
    i = np.arange(w, d_length - w + 1)
    sum1 = sums[i] - sums[i - w]      # f64 (== sums[i] at i==w, sums[0]=0)
    sumsq1 = sumsqs[i] - sumsqs[i - w]
    wf32 = np.float32(w)
    wf64 = np.float64(wf32)
    # float right-window sums (events.c:349-350)
    sum2 = (sums[i + w] - sums[i]).astype(np.float32)
    sumsq2 = (sumsqs[i + w] - sumsqs[i]).astype(np.float32)
    mean1 = (sum1 / wf64).astype(np.float32)        # double div -> float
    mean2 = sum2 / wf32                             # float division
    combined_var = (
        (sumsq1 / wf64)                             # double
        - (mean1 * mean1).astype(np.float64)        # float mult
        + (sumsq2 / wf32).astype(np.float64)        # float division
        - (mean2 * mean2).astype(np.float64)        # float mult
    ).astype(np.float32)
    combined_var = np.maximum(combined_var, eta)
    delta_mean = mean2 - mean1                      # float
    tstat[w : d_length - w + 1] = (
        np.abs(delta_mean.astype(np.float64))
        / np.sqrt((combined_var / wf32).astype(np.float64))
    ).astype(np.float32)
    return tstat


def short_long_peak_detector(
    tstat1: np.ndarray,
    tstat2: np.ndarray,
    threshold1: float,
    threshold2: float,
    window_length1: int,
    window_length2: int,
    peak_height: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Coupled two-detector peak finder; returns (positions, commits).

    Exact port of the state machine, ref events.c:375-447. `commits[k]`
    is the loop step at which peak k was appended -- the basis of the
    prefix-bounded eventization proof (see detect_events_prefix): the
    joint detector state at step i depends only on t-stats at steps
    <= i, so peaks committed before the first step whose t-stat is
    affected by a signal truncation are bit-identical to the
    full-signal run's.
    """
    n = tstat1.size
    FLT_MAX = np.float32(np.finfo(np.float32).max)

    class _Det:
        __slots__ = ("signal", "threshold", "window_length", "masked_to", "peak_pos", "peak_value", "valid_peak")

        def __init__(self, signal, threshold, window_length):
            self.signal = signal
            self.threshold = np.float32(threshold)
            self.window_length = window_length
            self.masked_to = 0
            self.peak_pos = -1
            self.peak_value = FLT_MAX
            self.valid_peak = False

    short = _Det(tstat1, threshold1, window_length1)
    long = _Det(tstat2, threshold2, window_length2)
    peaks: list[int] = []
    commits: list[int] = []

    for i in range(n):
        for det in (short, long):
            if det.masked_to >= i:
                continue
            current_value = det.signal[i]
            if det.peak_pos == -1:
                if current_value < det.peak_value:
                    det.peak_value = current_value
                elif current_value - det.peak_value > peak_height:
                    det.peak_value = current_value
                    det.peak_pos = i
            else:
                if current_value > det.peak_value:
                    det.peak_value = current_value
                    det.peak_pos = i
                if det is short and det.peak_value > det.threshold:
                    long.masked_to = det.peak_pos + det.window_length
                    long.peak_pos = -1
                    long.peak_value = FLT_MAX
                    long.valid_peak = False
                if det.peak_value - current_value > peak_height and det.peak_value > det.threshold:
                    det.valid_peak = True
                if det.valid_peak and (i - det.peak_pos) > det.window_length // 2:
                    peaks.append(det.peak_pos)
                    commits.append(i)
                    det.peak_pos = -1
                    det.peak_value = current_value
                    det.valid_peak = False

    return np.asarray(peaks, dtype=np.int64), np.asarray(commits, dtype=np.int64)


def create_events(
    peaks: np.ndarray,
    sums: np.ndarray,
    sumsqs: np.ndarray,
    nsample: int,
    commits: np.ndarray | None = None,
    exact_limit: int | None = None,
) -> EventTable | tuple[EventTable, int]:
    """Events from boundary list. ref: events.c:461-508.

    The reference keeps only peaks in (0, nsample); boundaries are
    [0, p0), [p0, p1), ..., [p_last, nsample). With commits+exact_limit
    also returns n_safe: the number of leading events whose closing
    peak committed before exact_limit (bit-identical to the full-signal
    run when the input signal was truncated -- see detect_events_prefix).
    """
    want_safe = commits is not None and exact_limit is not None
    if want_safe:
        keep = (peaks > 0) & (peaks < nsample)
        commits = commits[keep]
        # commits are nondecreasing (append order); events are closed by
        # kept peaks in order, the final to-nsample event is safe only
        # when the whole signal is exact
        n_safe = int(np.searchsorted(commits, exact_limit, side="left"))
        if exact_limit >= nsample:
            n_safe = commits.size + 1
    peaks = peaks[(peaks > 0) & (peaks < nsample)]
    bounds = np.empty(peaks.size + 2, dtype=np.int64)
    bounds[0] = 0
    bounds[1:-1] = peaks
    bounds[-1] = nsample
    starts = bounds[:-1]
    ends = bounds[1:]
    length = (ends - starts).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = (sums[ends] - sums[starts]).astype(np.float32) / length
        deltasqr = (sumsqs[ends] - sumsqs[starts]).astype(np.float32)
        var = deltasqr / length - mean * mean
    stdv = np.sqrt(np.maximum(var, np.float32(0.0)))
    et = EventTable(
        start=starts.astype(np.uint64),
        length=length,
        mean=mean.astype(np.float32),
        stdv=stdv.astype(np.float32),
    )
    return (et, n_safe) if want_safe else et


def detect_events(signal_pa: np.ndarray, rna: bool = False) -> EventTable:
    """Segment a pA signal into events. ref: events.c:510-554."""
    et, _ = detect_events_prefix(signal_pa, rna=rna, exact_limit=signal_pa.size)
    return et


def detect_events_prefix(
    signal_pa: np.ndarray, rna: bool, exact_limit: int
) -> tuple[EventTable, int]:
    """detect_events plus the count of PREFIX-EXACT events.

    When signal_pa is a truncated prefix full[:S] of a longer signal,
    t-stats at positions > S - w2 differ from the full-signal run (the
    right window crosses the cut; truncated entries are edge zeros).
    Peak commits at steps < exact_limit (caller passes S - w2) depend
    only on exact t-stats, so the first n_safe events are bit-identical
    to the full run's first n_safe events. Basis of the bounded
    eventization fast path (runtime/pipeline.py)."""
    params = RNA_PARAMS if rna else DNA_PARAMS
    n = signal_pa.size
    sums, sumsqs = compute_prefix_sums(signal_pa.astype(np.float32))
    tstat1 = compute_tstat(sums, sumsqs, n, params["window_length1"])
    tstat2 = compute_tstat(sums, sumsqs, n, params["window_length2"])
    peaks, commits = short_long_peak_detector(
        tstat1,
        tstat2,
        params["threshold1"],
        params["threshold2"],
        params["window_length1"],
        params["window_length2"],
        params["peak_height"],
    )
    return create_events(
        peaks, sums, sumsqs, n, commits=commits, exact_limit=exact_limit
    )


def get_events(signal_pa: np.ndarray, rna: bool = False) -> EventTable:
    """Public entry matching getevents(); no raw trimming (dead code in
    reference, events.c:557-576). Uses the native (C++) detector when
    built -- bit-exact against this module (tests/test_native.py)."""
    from .. import native

    res = native.detect_events(signal_pa, rna=rna)
    if res is not None:
        return EventTable(start=res[0], length=res[1], mean=res[2], stdv=res[3])
    return detect_events(signal_pa, rna=rna)


def get_events_prefix(
    signal_pa: np.ndarray, rna: bool, exact_limit: int
) -> tuple[EventTable, int]:
    """get_events over a truncated signal prefix, plus the count of
    events guaranteed bit-identical to the full-signal run (see
    detect_events_prefix). Native-accelerated."""
    from .. import native

    res = native.detect_events(signal_pa, rna=rna, exact_limit=exact_limit)
    if res is not None:
        st, ln, mn, sd, n_safe = res
        return EventTable(start=st, length=ln, mean=mn, stdv=sd), n_safe
    return detect_events_prefix(signal_pa, rna=rna, exact_limit=exact_limit)
