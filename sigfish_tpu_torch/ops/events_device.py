"""Batched event detection on the device (`--host-stages device`): the
wrapper of csrc/events.cu and the plain PyTorch versions of its stages.

The counterpart of sigfish_tpu/ops/events_device.py. A batch of reads is
one time-major (S, B) i16 plane, zero-padded past each read's nsample;
each read is a lane, and its samples are walked in order:

  pA          (raw + offset) * raw_unit in the f32 order of to_pa, with
              raw_unit = f32(range) / f32(digitisation) from the host
              (ref sigfish.c:344-347)
  prefix sums A, Q: (S+1, B) f64, sequential sums of the f32 values and
              of their f32 squares (the square rounded to f32 before the
              f64 add, events.c:297-307, fuzz seed 1090), frozen past
              each read's nsample
  t-stats     the Welch t-stat at windows w1 and w2 with events.c:319-
              368's float/double mixing, operation by operation; 0
              outside [w, n - w]
  detector    the coupled short/long peak state machine (events.c:375-
              447): short before long within a step, a short peak over
              its threshold masks and resets the long detector; commits
              with pos > 0 are appended, at most E of them, past which
              the read's overflow flag is set
  gather      A and Q at each peak and at n

create_events (events.c:461-508) stays on the host in numpy, as in the
JAX package, so only O(B x E) values come back. An overflowing read gets
None and takes the host path (runtime/pipeline._event_batch_device).

On the card one detect_peaks call is one sf_events call: four launches
in order (prefix, t-stat, detector, gather; csrc/events.cu), with the two
t-stat planes as (S, B) f32 scratch the wrapper allocates. The *_stage
functions run one stage alone, for checks and stage times: on a CPU
tensor its plain version, on a CUDA tensor its launch (not counted in
detect_peaks.launches, which counts whole eventizer calls). The kernels'
rings copy 16-byte chunks of a time-major row, so on the card a batch
runs lane_width(B) reads wide, the added lanes reads of 0 samples, and
the results are cut back to B.

The stages' order is fixed bit for bit: the prefix sums are a loop over
samples (never torch.cumsum, whose CUDA order is a parallel scan), and
the detector a loop over steps with (B,) state lanes. The card's f64 is
IEEE, so the tables are bit-equal to the host eventizer
(ops/events.detect_events). On a CPU tensor detect_peaks runs the plain
versions; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .events import DNA_PARAMS, RNA_PARAMS, EventTable

FLT_MAX = float(np.finfo(np.float32).max)
ETA = float(np.finfo(np.float32).tiny)


class Peaks(NamedTuple):
    """What the eventizer leaves on the device for one batch: the prefix
    planes (S+1, B) f64, the peak boundaries (B, E) i32 with their counts
    (B,) i32 and overflow flags (B,) bool, A and Q gathered at the peaks
    (B, E) f64 (A[0] = 0 in unused slots) and at n (B,) f64."""

    A: torch.Tensor
    Q: torch.Tensor
    peaks: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor
    psum: torch.Tensor
    psumsq: torch.Tensor
    end_sum: torch.Tensor
    end_sumsq: torch.Tensor


LANE_ALIGN = 8  # i16 columns in a 16-byte chunk


def lane_width(B: int) -> int:
    """The batch width the card kernels run at: B rounded up to a
    multiple of LANE_ALIGN, so each row of a plane is whole chunks."""
    return -(-B // LANE_ALIGN) * LANE_ALIGN


def pad_lanes(t: torch.Tensor, width: int) -> torch.Tensor:
    """t (..., B) as a contiguous, 16-byte-aligned (..., width) tensor,
    zero in the added columns; t itself when it is one already."""
    B = t.shape[-1]
    if B == width and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., :B] = t
    return out


def event_cap(S: int) -> int:
    """E, the per-read peak cap of an S-sample bucket (reads average
    >= 4 samples an event; past E a read takes the host path)."""
    return max(64, S // 4)


def pa_plain(sig_t: torch.Tensor, raw_unit: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """(S, B) f32 pA: (raw + offset) * raw_unit, two f32 roundings."""
    return (sig_t.to(torch.float32) + offset[None, :]) * raw_unit[None, :]


def prefix_sums_plain(pa_t: torch.Tensor, nsamples: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, Q), (S+1, B) f64: A[k] the sequential f64 sum of a read's
    first min(k, n) f32 values, Q of their f32 squares. A loop over
    samples with (B,) lanes; adding the masked +0.0 past n leaves a sum
    bit for bit as it was."""
    S, B = pa_t.shape
    dev = pa_t.device
    live = torch.arange(S, device=dev)[:, None] < nsamples[None, :]
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    v = torch.where(live, pa_t.to(torch.float64), zero).unbind(0)
    # the f32 square, rounded to f32 before the f64 add (seed 1090)
    vv = torch.where(live, (pa_t * pa_t).to(torch.float64), zero).unbind(0)
    s = torch.zeros(B, dtype=torch.float64, device=dev)
    q = torch.zeros(B, dtype=torch.float64, device=dev)
    ss, qq = [s], [q]
    for i in range(int(nsamples.max()) if B else 0):
        s = s + v[i]
        q = q + vv[i]
        ss.append(s)
        qq.append(q)
    # past the longest read every sum is frozen
    ss += [s] * (S + 1 - len(ss))
    qq += [q] * (S + 1 - len(qq))
    return torch.stack(ss), torch.stack(qq)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The square root of x > 0 rounded to nearest, in x's dtype. torch's
    CPU sqrt (MKL's vector library) is faithful, not correctly rounded:
    about 0.7% of f32 and f64 roots are one ulp off. One Newton step on an
    exact residual fixes the f64 root: r * r = P + E exactly (Dekker's
    product), x - r * r has the sign of (x - P) - E, and r + (x - r^2) /
    (2 r) rounds to the correct root unless the exact root lies within
    about 2^-50 ulp of a rounding midpoint. An f32 root is taken in f64 and rounded
    once more, which is exact for roots of f32 values. On the card torch's
    sqrt is already correctly rounded, and the step leaves it as it is."""
    if x.dtype == torch.float32:
        return sqrt_rn(x.to(torch.float64)).to(torch.float32)
    r = torch.sqrt(x)
    c = r * 134217729.0  # 2^27 + 1: Veltkamp's split of r into hi + lo
    hi = c - (c - r)
    lo = r - hi
    P = r * r
    E = ((hi * hi - P) + 2.0 * hi * lo) + lo * lo
    return torch.where((r > 0) & (r < float("inf")), r + ((x - P) - E) / (2.0 * r), r)


def tstat_plain(A: torch.Tensor, Q: torch.Tensor, nsamples: torch.Tensor, w: int) -> torch.Tensor:
    """(S, B) f32 t-stat at window w, in the host compute_tstat's
    float/double order (ops/events.py), 0 outside [w, n - w].

    Every division is by a tensor on the data's device: torch's CUDA
    division by a CPU scalar multiplies by its reciprocal. Torch does not
    flush subnormals on the CPU, nor does the card's IEEE division, so
    the f32 quotient combined_var / w, subnormal on near-flat windows,
    needs no emulation of XLA's flushed grid (sigfish_tpu's
    events_device._tstat)."""
    S = A.shape[0] - 1
    B = A.shape[1]
    dev = A.device
    z = torch.zeros((w, B), dtype=torch.float64, device=dev)
    s_i, q_i = A[:S], Q[:S]
    s_im = torch.cat([z, A[: S - w]])
    q_im = torch.cat([z, Q[: S - w]])
    s_ip = torch.cat([A[w:], z[: w - 1]])
    q_ip = torch.cat([Q[w:], z[: w - 1]])
    wf32 = torch.tensor(float(w), dtype=torch.float32, device=dev)
    wf64 = wf32.to(torch.float64)
    sum1 = s_i - s_im
    sumsq1 = q_i - q_im
    sum2 = (s_ip - s_i).to(torch.float32)
    sumsq2 = (q_ip - q_i).to(torch.float32)
    mean1 = (sum1 / wf64).to(torch.float32)
    mean2 = sum2 / wf32
    combined_var = (
        sumsq1 / wf64
        - (mean1 * mean1).to(torch.float64)
        + (sumsq2 / wf32).to(torch.float64)
        - (mean2 * mean2).to(torch.float64)
    ).to(torch.float32)
    eta = torch.tensor(ETA, dtype=torch.float32, device=dev)
    combined_var = torch.where(combined_var < eta, eta, combined_var)
    delta_mean = mean2 - mean1
    ts = (
        delta_mean.to(torch.float64).abs() / sqrt_rn((combined_var / wf32).to(torch.float64))
    ).to(torch.float32)
    i = torch.arange(S, device=dev)[:, None]
    valid = (i >= w) & (i <= nsamples[None, :] - w)
    return torch.where(valid, ts, torch.zeros((), dtype=torch.float32, device=dev))


def _det_step(i, i_half, cv, st, live, ph, thr, neg1):
    """One detector at step i (an i32 tensor, i_half = i - window // 2),
    (B,) lanes; st = (masked_to, peak_pos, peak_value, valid_peak).
    Returns (new state, commit mask, the committed position, the tracking
    mask and the peak value after the rise update, before the commit's
    reset)."""
    m, pp, pv, vp = st
    act = live & (m < i)
    searching = pp < 0
    sel_s = act & searching
    sel_t = act & ~searching
    # searching (events.c peak_pos == DEF_PEAK_POS); cv < pv implies
    # cv - pv < 0 < peak_height
    lt = cv < pv
    found = (cv - pv) > ph
    pv_s = torch.where(lt | found, cv, pv)
    pp_s = torch.where(found, i, pp)
    # tracking
    gt = cv > pv
    pv_t = torch.where(gt, cv, pv)
    pp_t = torch.where(gt, i, pp)
    vp_t = vp | (((pv_t - cv) > ph) & (pv_t > thr))
    commit = vp_t & (pp_t < i_half)
    pp_n = torch.where(sel_s, pp_s, torch.where(sel_t, torch.where(commit, neg1, pp_t), pp))
    pv_n = torch.where(sel_s, pv_s, torch.where(sel_t, torch.where(commit, cv, pv_t), pv))
    vp_n = torch.where(sel_t, vp_t & ~commit, vp)
    return (m, pp_n, pv_n, vp_n), sel_t & commit, pp_t, sel_t, pv_t


def detector_plain(
    t1: torch.Tensor, t2: torch.Tensor, nsamples: torch.Tensor, params: dict, E: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The coupled short/long peak detector (events.c:375-447) as a loop
    over steps with (B,) state lanes. Returns (peaks (B, E) i32, counts
    (B,) i32, overflow (B,) bool): per read the first E committed
    positions > 0 in commit order (short before long within a step)."""
    S, B = t1.shape
    dev = t1.device
    w1, w2 = params["window_length1"], params["window_length2"]
    f32 = dict(dtype=torch.float32, device=dev)
    thr1 = torch.tensor(params["threshold1"], **f32)
    thr2 = torch.tensor(params["threshold2"], **f32)
    ph = torch.tensor(params["peak_height"], **f32)
    flt_max = torch.tensor(FLT_MAX, **f32)

    def fresh():
        return (
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), -1, dtype=torch.int32, device=dev),
            torch.full((B,), FLT_MAX, **f32),
            torch.zeros(B, dtype=torch.bool, device=dev),
        )

    st_s, st_l = fresh(), fresh()
    steps = int(nsamples.max()) if B else 0
    live = (torch.arange(steps, device=dev)[:, None] < nsamples[None, :]).unbind(0)
    r1, r2 = t1[:steps].unbind(0), t2[:steps].unbind(0)
    # the step index and its windows' commit limits as i32 tensors: a
    # Python scalar costs a conversion in every op
    ii = torch.arange(steps, dtype=torch.int32, device=dev)
    i_t, ih1, ih2 = ii.unbind(0), (ii - w1 // 2).unbind(0), (ii - w2 // 2).unbind(0)
    neg1 = torch.tensor(-1, dtype=torch.int32, device=dev)
    w1_t = torch.tensor(w1, dtype=torch.int32, device=dev)
    commits, positions = [], []
    for i in range(steps):
        st_s, c_s, p_s, tr_s, pv_s = _det_step(i_t[i], ih1[i], r1[i], st_s, live[i], ph, thr1, neg1)
        # a short peak over threshold masks and resets the long detector
        # (events.c: long.masked_to = short.peak_pos + short.window_length)
        fire = tr_s & (pv_s > thr1)
        st_l = (torch.where(fire, p_s + w1_t, st_l[0]), torch.where(fire, neg1, st_l[1]),
                torch.where(fire, flt_max, st_l[2]), st_l[3] & ~fire)
        st_l, c_l, p_l, _, _ = _det_step(i_t[i], ih2[i], r2[i], st_l, live[i], ph, thr2, neg1)
        commits += [c_s, c_l]
        positions += [p_s, p_l]
    peaks = torch.zeros((B, E), dtype=torch.int32, device=dev)
    if not commits:
        return peaks, torch.zeros(B, dtype=torch.int32, device=dev), torch.zeros(
            B, dtype=torch.bool, device=dev)
    pos = torch.stack(positions)  # (2 steps, B), commit order
    eff = torch.stack(commits) & (pos > 0)
    rank = torch.cumsum(eff.to(torch.int64), 0) - 1
    total = eff.sum(0)
    k, b = torch.nonzero(eff & (rank < E), as_tuple=True)
    peaks[b, rank[k, b]] = pos[k, b]
    return peaks, torch.clamp(total, max=E).to(torch.int32), total > E


def _gather(A: torch.Tensor, Q: torch.Tensor, peaks: torch.Tensor, nsamples: torch.Tensor):
    S = A.shape[0] - 1
    pk = torch.clamp(peaks, max=S).long()
    lanes = torch.arange(A.shape[1], device=A.device)
    n = nsamples.long()
    return (torch.gather(A.t(), 1, pk), torch.gather(Q.t(), 1, pk), A[n, lanes], Q[n, lanes])


def detect_peaks_plain(sig_t, nsamples, raw_unit, offset, rna: bool, E: int) -> Peaks:
    """The plain version of the kernel, stage by stage, on whatever
    device the tensors lie on."""
    params = RNA_PARAMS if rna else DNA_PARAMS
    A, Q = prefix_sums_plain(pa_plain(sig_t, raw_unit, offset), nsamples)
    t1 = tstat_plain(A, Q, nsamples, params["window_length1"])
    t2 = tstat_plain(A, Q, nsamples, params["window_length2"])
    peaks, counts, overflow = detector_plain(t1, t2, nsamples, params, E)
    return Peaks(A, Q, peaks, counts, overflow, *_gather(A, Q, peaks, nsamples))


def detect_peaks(
    sig_t: torch.Tensor,     # (S, B) i16, time-major, zero-padded
    nsamples: torch.Tensor,  # (B,) i32, each <= S
    raw_unit: torch.Tensor,  # (B,) f32
    offset: torch.Tensor,    # (B,) f32
    rna: bool,
    E: int,
) -> Peaks:
    """One eventizer launch over a (S, B) batch. CPU tensors run
    detect_peaks_plain; CUDA tensors launch csrc/events.cu on the current
    stream (counted in detect_peaks.launches) or raise."""
    if sig_t.dtype != torch.int16 or sig_t.dim() != 2:
        raise ValueError(f"detect_peaks: want int16 (S, B); got {sig_t.dtype} {tuple(sig_t.shape)}")
    S, B = sig_t.shape
    for name, t, dt in (("nsamples", nsamples, torch.int32), ("raw_unit", raw_unit, torch.float32),
                        ("offset", offset, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != (B,) or t.device != sig_t.device:
            raise ValueError(f"detect_peaks: {name} must be {dt} ({B},) on {sig_t.device}")
    if E < 1:
        raise ValueError(f"detect_peaks: E {E} < 1")
    if sig_t.device.type == "cpu":
        return detect_peaks_plain(sig_t, nsamples, raw_unit, offset, rna, E)
    if sig_t.device.type != "cuda":
        raise ValueError(f"detect_peaks: unsupported device {sig_t.device}")
    params = RNA_PARAMS if rna else DNA_PARAMS
    dev = sig_t.device
    W = lane_width(B)
    sig_t, nsamples, raw_unit, offset = (pad_lanes(t, W) for t in (sig_t, nsamples, raw_unit,
                                                                   offset))
    f64 = dict(dtype=torch.float64, device=dev)
    A = torch.empty((S + 1, W), **f64)
    Q = torch.empty((S + 1, W), **f64)
    # every output is written whole: the gather zeroes the unused slots
    peaks = torch.empty((W, E), dtype=torch.int32, device=dev)
    counts = torch.empty(W, dtype=torch.int32, device=dev)
    overflow = torch.empty(W, dtype=torch.bool, device=dev)
    psum = torch.empty((W, E), **f64)
    psumsq = torch.empty((W, E), **f64)
    end_sum = torch.empty(W, **f64)
    end_sumsq = torch.empty(W, **f64)
    t1, t2 = (torch.empty((S, W), dtype=torch.float32, device=dev) for _ in range(2))
    _launch(dev, "detect_peaks", _library().sf_events,
        sig_t.data_ptr(), nsamples.data_ptr(), raw_unit.data_ptr(), offset.data_ptr(), S, W, E,
        params["window_length1"], params["window_length2"], params["threshold1"],
        params["threshold2"], params["peak_height"], A.data_ptr(), Q.data_ptr(),
        peaks.data_ptr(), counts.data_ptr(), overflow.data_ptr(), psum.data_ptr(),
        psumsq.data_ptr(), end_sum.data_ptr(), end_sumsq.data_ptr(), t1.data_ptr(),
        t2.data_ptr(),
    )
    detect_peaks.launches += 1
    return Peaks(A[:, :B], Q[:, :B], peaks[:B], counts[:B], overflow[:B], psum[:B], psumsq[:B],
                 end_sum[:B], end_sumsq[:B])


detect_peaks.launches = 0


def _launch(dev: torch.device, name: str, entry, *args) -> None:
    """Call a C entry with args and dev's current stream, with dev the
    current device: the runtime launches on, and cudaFuncSetAttribute
    sets the shared memory of, the calling thread's current device."""
    with torch.cuda.device(dev):
        err = entry(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def _want(name: str, nsamples: torch.Tensor, *specs) -> torch.device:
    """The one device of a stage's tensors, checked as a CUDA stage reads
    them through raw pointers: nsamples (B,) i32, and each (tensor, dtype)
    of specs contiguous, of that dtype, B columns wide, on that device."""
    dev = nsamples.device
    B = nsamples.shape[0]
    for t, dt in ((nsamples, torch.int32), *specs):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() or t.shape[-1] != B:
            raise ValueError(f"{name}: want contiguous {dt} tensors {B} wide on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def prefix_stage(sig_t, nsamples, raw_unit, offset):
    """Stage a alone: (A, Q, end_sum, end_sumsq), the (S+1, B) f64 prefix
    planes and their (B,) values at n."""
    dev = _want("prefix_stage", nsamples, (sig_t, torch.int16), (raw_unit, torch.float32),
                (offset, torch.float32))
    S, B = sig_t.shape
    if dev.type == "cpu":
        A, Q = prefix_sums_plain(pa_plain(sig_t, raw_unit, offset), nsamples)
        lanes, n = torch.arange(B), nsamples.long()
        return A, Q, A[n, lanes], Q[n, lanes]
    W = lane_width(B)
    sig_t, nsamples, raw_unit, offset = (pad_lanes(t, W) for t in (sig_t, nsamples, raw_unit,
                                                                   offset))
    f64 = dict(dtype=torch.float64, device=dev)
    A, Q = torch.empty((S + 1, W), **f64), torch.empty((S + 1, W), **f64)
    end_sum, end_sumsq = torch.empty(W, **f64), torch.empty(W, **f64)
    _launch(dev, "prefix_stage", _library().sf_events_prefix,
        sig_t.data_ptr(), nsamples.data_ptr(), raw_unit.data_ptr(), offset.data_ptr(), S, W,
        A.data_ptr(), Q.data_ptr(), end_sum.data_ptr(), end_sumsq.data_ptr(),
    )
    return A[:, :B], Q[:, :B], end_sum[:B], end_sumsq[:B]


def tstat_stage(A, Q, nsamples, rna: bool):
    """Stage b alone: the (S, B) f32 t-stat planes (t1, t2) at the
    chemistry's two windows."""
    dev = _want("tstat_stage", nsamples, (A, torch.float64), (Q, torch.float64))
    params = RNA_PARAMS if rna else DNA_PARAMS
    w1, w2 = params["window_length1"], params["window_length2"]
    if dev.type == "cpu":
        return tstat_plain(A, Q, nsamples, w1), tstat_plain(A, Q, nsamples, w2)
    S, B = A.shape[0] - 1, A.shape[1]
    t1, t2 = (torch.empty((S, B), dtype=torch.float32, device=dev) for _ in range(2))
    _launch(dev, "tstat_stage", _library().sf_events_tstat,
        A.data_ptr(), Q.data_ptr(), nsamples.data_ptr(), S, B, w1, w2, t1.data_ptr(),
        t2.data_ptr(),
    )
    return t1, t2


def detector_stage(t1, t2, nsamples, rna: bool, E: int):
    """Stage c alone: (peaks (B, E) i32, counts (B,) i32, overflow (B,)
    bool). The kernel writes a read's first counts slots; here the rest
    are 0, as detector_plain's."""
    dev = _want("detector_stage", nsamples, (t1, torch.float32), (t2, torch.float32))
    params = RNA_PARAMS if rna else DNA_PARAMS
    if dev.type == "cpu":
        return detector_plain(t1, t2, nsamples, params, E)
    S, B = t1.shape
    W = lane_width(B)
    t1, t2, nsamples = (pad_lanes(t, W) for t in (t1, t2, nsamples))
    peaks = torch.zeros((W, E), dtype=torch.int32, device=dev)
    counts = torch.empty(W, dtype=torch.int32, device=dev)
    overflow = torch.empty(W, dtype=torch.bool, device=dev)
    _launch(dev, "detector_stage", _library().sf_events_detect,
        t1.data_ptr(), t2.data_ptr(), nsamples.data_ptr(), S, W, E, params["window_length1"],
        params["window_length2"], params["threshold1"], params["threshold2"],
        params["peak_height"], peaks.data_ptr(), counts.data_ptr(), overflow.data_ptr(),
    )
    return peaks[:B], counts[:B], overflow[:B]


def gather_stage(A, Q, peaks, counts, nsamples):
    """Stage d alone: (psum, psumsq), A and Q at each read's first counts
    peaks, 0 in the other slots. On the card it runs on a copy of peaks
    (the kernel zeroes the slots past each count)."""
    dev = _want("gather_stage", nsamples, (A, torch.float64), (Q, torch.float64),
                (counts, torch.int32))
    if peaks.dtype != torch.int32 or peaks.device != dev or tuple(peaks.shape)[0] != A.shape[1]:
        raise ValueError(f"gather_stage: want int32 peaks ({A.shape[1]}, E) on {dev}")
    if dev.type == "cpu":
        return _gather(A, Q, peaks, nsamples)[:2]
    B, E = peaks.shape
    peaks = peaks.clone()
    psum, psumsq = (torch.empty((B, E), dtype=torch.float64, device=dev) for _ in range(2))
    _launch(dev, "gather_stage", _library().sf_events_gather,
        A.data_ptr(), Q.data_ptr(), counts.data_ptr(), B, E, peaks.data_ptr(), psum.data_ptr(),
        psumsq.data_ptr(),
    )
    return psum, psumsq


_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """csrc/events.cu's library, built on first use."""
    global _lib
    if _lib is None:
        from ..kernels.build import load_library

        lib = load_library("events")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sf_events.argtypes = [p, p, p, p, i, i, i, i, i, f, f, f] + [p] * 11 + [p]
        lib.sf_events_prefix.argtypes = [p, p, p, p, i, i, p, p, p, p, p]
        lib.sf_events_tstat.argtypes = [p, p, p, i, i, i, i, p, p, p]
        lib.sf_events_detect.argtypes = [p, p, p, i, i, i, i, i, f, f, f, p, p, p, p]
        lib.sf_events_gather.argtypes = [p, p, p, i, i, p, p, p, p]
        lib.sf_events_detector_smem.argtypes = []
        for fn in (lib.sf_events, lib.sf_events_prefix, lib.sf_events_tstat,
                   lib.sf_events_detect, lib.sf_events_gather, lib.sf_events_detector_smem):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def detector_smem_bytes() -> int:
    """The dynamic shared memory a detector block takes (its two t-stat
    rings and the tile records its three warps share), from the built
    library."""
    return int(_library().sf_events_detector_smem())


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host. From the card: a copy into pinned
    memory on the current stream and a wait on an event recorded behind
    it, so only that stream's work is waited for."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    ev.synchronize()
    return host.numpy()


def batch_tensors(signals, nsamples, digitisation, offset, range_, device) -> tuple:
    """The (S, B) i16 time-major plane, nsamples (B,) i32, raw_unit and
    offset (B,) f32 of a (B, S) numpy batch, on `device`. raw_unit is
    f32(range) / f32(digitisation), rounded on the host as to_pa does."""
    raw_unit = range_.astype(np.float32) / digitisation.astype(np.float32)
    dev = torch.device(device)
    return (
        torch.from_numpy(np.ascontiguousarray(signals.T)).to(dev),
        torch.from_numpy(nsamples.astype(np.int32)).to(dev),
        torch.from_numpy(raw_unit.astype(np.float32)).to(dev),
        torch.from_numpy(offset.astype(np.float32)).to(dev),
    )


def detect_events_batch(
    signals: np.ndarray,       # (B, S) i16, zero-padded
    nsamples: np.ndarray,      # (B,) i32
    digitisation: np.ndarray,  # (B,) f64
    offset: np.ndarray,        # (B,) f64
    range_: np.ndarray,        # (B,) f64
    rna: bool,
    device="cuda",
) -> tuple[list[EventTable | None], np.ndarray]:
    """Batched event detection on `device`. Returns (per-read EventTable
    list, overflow mask); a read overflowing the E cap gets None and must
    take the host path. Bit-equal to ops/events.detect_events read by
    read (the card's f64 is IEEE)."""
    B, S = signals.shape
    E = event_cap(S)
    res = detect_peaks(*batch_tensors(signals, nsamples, digitisation, offset, range_, device),
                       rna, E)
    return assemble_events(res, nsamples)


def assemble_events(res: Peaks, nsamples: np.ndarray) -> tuple[list[EventTable | None], np.ndarray]:
    """create_events (events.c:461-508) on the host, in numpy's f32 math,
    from a launch's counts and the first max(counts) gathered sums."""
    counts = to_host(res.counts)
    overflow = to_host(res.overflow)
    end_sum = to_host(res.end_sum)
    end_sumsq = to_host(res.end_sumsq)
    n_pk = int(counts.max(initial=0))
    peaks = to_host(res.peaks[:, :n_pk].contiguous()).astype(np.int64)
    psum = to_host(res.psum[:, :n_pk].contiguous())
    psumsq = to_host(res.psumsq[:, :n_pk].contiguous())
    out: list[EventTable | None] = []
    for b in range(counts.shape[0]):
        if overflow[b]:
            out.append(None)
            continue
        c = int(counts[b])
        starts_b = np.empty(c + 1, np.int64)
        starts_b[0] = 0
        starts_b[1:] = peaks[b, :c]
        ends_b = np.empty(c + 1, np.int64)
        ends_b[:-1] = peaks[b, :c]
        ends_b[-1] = int(nsamples[b])
        s_sum = np.concatenate([[0.0], psum[b, :c]])
        s_sumsq = np.concatenate([[0.0], psumsq[b, :c]])
        e_sum = np.concatenate([psum[b, :c], [end_sum[b]]])
        e_sumsq = np.concatenate([psumsq[b, :c], [end_sumsq[b]]])
        length = (ends_b - starts_b).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean = (e_sum - s_sum).astype(np.float32) / length
            deltasqr = (e_sumsq - s_sumsq).astype(np.float32)
            var = deltasqr / length - mean * mean
        stdv = np.sqrt(np.maximum(var, np.float32(0.0)))
        out.append(EventTable(
            start=starts_b.astype(np.uint64),
            length=length,
            mean=mean.astype(np.float32),
            stdv=stdv.astype(np.float32),
        ))
    return out, overflow
