"""Batched RNA polyA autodetect on the device (`--host-stages device`
with RNA -p -1): the wrapper of csrc/polya.cu and its plain PyTorch
version.

The counterpart of sigfish_tpu/ops/jnn_device.py (_polya_end_jit). Each
read is a lane of a time-major (S, B) i16 plane, walked in order by five
sequential f32 passes:

  P1  the rolling mean t of the raw samples clamped to [0, 1200], as
      jnn.c's running accumulator (tt -= x[i-1]; tt += x[i+w-1],
      jnn.c:37-46, w = 2000)
  P2  meanf / stdvf of t (stat.h:17-48) -> bot = mean - std * scale
  P3  the jnnv2 segment machine over t (jnn.c:113-168) -> the adaptor
      (ax, ay)
  P4  m_a = meanf of the pA samples in [ax, ay) (sigfish.c:393)
  P5  the jnn_core machine over the clamped pA tail from ay with the band
      (m_a + 30) +- 20 in the C reference's f32 order (jnn.c:191-279,
      sigfish.c:396) -> the polyA end, or -1

The answer is held bit for bit to sigfish_tpu.ops.jnn_device.polya_end_
batch, which runs on XLA's CPU backend. That backend rounds three spots
its own way, and both versions here follow it:
  - P1's t = tt / w is compiled as tt * f32(1 / w) (XLA rewrites a
    division by a constant into a product with its reciprocal);
  - P2's std sum acc + d * d and bot = mean - std * scale are each
    contracted into one fused multiply-add (one rounding).
The host port (ops/jnn.detect_polya_end) rounds otherwise and carries the
polyA band in f64, so a read can in principle get another answer there;
the tests print any such read.

On a CPU tensor polya_end runs polya_end_plain; on a CUDA tensor it
launches csrc/polya.cu or raises. The kernel streams each warp's samples
through shared-memory rings (ring_bytes() of dynamic shared memory a
block) and walks a read four times: t is recomputed from the samples in
each of P1, P2 and P3 rather than stored, and P4 and P5 share a walk.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .events_device import batch_tensors, lane_width, pad_lanes, sqrt_rn, to_host
from .jnn import (
    JNNV1_R9_POLYA,
    JNNV1_RNA004_POLYA,
    JNNV2_RNA_R9_ADAPTOR,
    JNNV2_RNA_RNA004_ADAPTOR,
    OUTLIER_MAX,
    OUTLIER_MIN,
    PORE_RNA004,
)


def pore_params(pore: int):
    """(jnnv2 adaptor params, jnn_core polyA params) of a chemistry."""
    if pore == PORE_RNA004:
        return JNNV2_RNA_RNA004_ADAPTOR, JNNV1_RNA004_POLYA
    return JNNV2_RNA_R9_ADAPTOR, JNNV1_R9_POLYA


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with one rounding, in plain torch ops."""
    p = a.to(torch.float64) * b.to(torch.float64)  # exact: 24 + 24 bits
    return _round_sum(p, c)


def _round_sum(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 RN(p + c) of an f64 p and an f32 c, exactly: the f64 sum is
    rounded to odd (TwoSum's exact error moves an even result one ulp
    towards the true value), and an f64 value rounded to odd rounds to
    f32 as the exact sum would."""
    c = c.to(torch.float64)
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    fix = (e != 0) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(fix, torch.nextafter(s, torch.copysign(torch.full_like(s, float("inf")), e)), s)
    return s.to(torch.float32)


def _clamp(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.clamp(x, min=OUTLIER_MIN), max=OUTLIER_MAX)


def _seq_sum(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Sequential f32 sum of rows [lo, hi) of x (S, B), zeros where a
    lane has nothing to add (acc + 0.0 is acc bit for bit)."""
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for row in x[lo:hi].unbind(0):
        acc = acc + row
    return acc


def mean_std_bot(x: torch.Tensor, valid: torch.Tensor, count: torch.Tensor, scale: float,
                 lo: int = 0):
    """P2 (stat.h:17-48 meanf / stdvf, jnn.c:107-111): sequential f32
    sums over the valid rows of x (S, B) from row lo, in the reference's
    rounding: the std sum acc + d * d and bot = mean - std * scale each as
    one fused multiply-add. Returns (mean, std, bot), (B,) f32."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    mn = _seq_sum(torch.where(valid, x, zero), lo, x.shape[0]) / count
    d = (x - mn[None, :]).to(torch.float64)
    dd = torch.where(valid, d * d, torch.zeros((), dtype=torch.float64, device=x.device))
    acc = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for row in dd[lo:].unbind(0):
        # a lane without a sample here adds an exact +0.0
        acc = _round_sum(row, acc)
    std = sqrt_rn(acc / count)
    return mn, std, fma32(-std, torch.tensor(scale, dtype=torch.float32, device=x.device), mn)


def polya_end_plain(sig_t, nsamples, raw_unit, offset, pore: int) -> torch.Tensor:
    """The five passes as loops over samples with (B,) lanes, on whatever
    device the tensors lie on; a transcription of _polya_end_jit's scan
    bodies. Returns (B,) i32 polyA ends, -1 where the autodetect fails."""
    S, B = sig_t.shape
    dev = sig_t.device
    v2, v1 = pore_params(pore)
    window = v2.window
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    n = nsamples
    n_max = int(n.max()) if B else 0
    idx = torch.arange(S, **i32)[:, None]
    sf = sig_t.to(torch.float32)
    clamped = _clamp(sf)
    pa = (sf + offset[None, :]) * raw_unit[None, :]
    zero = torch.zeros((), **f32)

    # P1: the running accumulator over k <= n - 2 (the subtract before
    # the add); t[k - window + 1] = tt_k * f32(1 / window)
    cl = clamped[:n_max].unbind(0)
    tt = torch.zeros(B, **f32)
    tts = []
    for k in range(max(n_max - 1, 0)):
        tt = tt + cl[k] if k < window else (tt - cl[k - window]) + cl[k]
        tts.append(tt)
    tts += [tt] * (S - len(tts))
    inv_w = torch.tensor(1.0, **f32) / torch.tensor(float(window), **f32)
    t_shift = torch.stack(tts) * inv_w
    t_valid = (idx >= window - 1) & (idx <= n[None, :] - 2)
    k_lo, k_hi = window - 1, max(n_max - 1, window - 1)
    nt = torch.clamp(n - window, min=1).to(torch.float32)

    # P2: meanf / stdvf over t -> bot
    bot = mean_std_bot(t_shift[:k_hi], t_valid[:k_hi], nt, v2.std_scale, k_lo)[2]

    # P3: the jnnv2 segment machine over t. Per-step constants are
    # tensors (a Python scalar costs a wrap per op), and the updates that
    # only a closing segment makes run on the steps where a lane closes:
    # on the others they change nothing
    def c32(v):
        return torch.tensor(v, **i32)

    zi = torch.zeros(B, **i32)
    zb = torch.zeros(B, dtype=torch.bool, device=dev)
    begin, found, have_l = zb, zb, zb
    start, end, l_s, l_e, r_x, r_y = zi, zi, zi, zi, zi, zi
    half, sd2, hi2, lo2 = c32(window // 2 - 1), c32(v2.seg_dist), c32(v2.hi_thresh), c32(
        v2.lo_thresh)
    tv, tsh = t_valid[:k_hi], t_shift[:k_hi]
    below_p = (tv & (tsh < bot[None, :])).unbind(0)
    above_p = (tv & (tsh > bot[None, :])).unbind(0)
    j_p = (idx[:k_hi] - (window - 1)).expand(k_hi, B).unbind(0)
    for k in range(k_lo, k_hi):
        below = below_p[k]
        close = above_p[k] & begin
        if bool(close.any()):
            ch = close & have_l
            merge = ch & ((start - l_e) < sd2)
            ln = l_e - l_s
            q = ch & ~merge & ~found & (ln <= hi2) & (ln >= lo2)
            r_x = torch.where(q, l_s + half, r_x)
            r_y = torch.where(q, l_e + half, r_y)
            found = found | q
            l_e = torch.where(merge, end, l_e)
            new = close & ~merge
            l_s = torch.where(new, start, l_s)
            l_e = torch.where(new, end, l_e)
            have_l = have_l | close
            start = torch.where(close, zi, start)
            end = torch.where(close, zi, end)
            begin = begin & ~close
        start = torch.where(below & ~begin, j_p[k], start)
        end = torch.where(below & begin, j_p[k], end)
        begin = begin | below
    ln = l_e - l_s
    q = have_l & ~found & (ln <= hi2) & (ln >= lo2)
    ax = torch.where(q, l_s + half, torch.where(found, r_x, zi))
    ay = torch.where(q, l_e + half, torch.where(found, r_y, zi))
    adaptor_ok = (n > window) & (ay > 0)

    # P4: m_a = meanf(pA[ax:ay])
    in_ad = (idx >= ax[None, :]) & (idx < ay[None, :]) & adaptor_ok[None, :]
    a_lo = int(torch.where(adaptor_ok, ax, S).min()) if B else 0
    a_hi = int(torch.where(adaptor_ok, ay, 0).max()) if B else 0
    m_a = _seq_sum(torch.where(in_ad, pa, zero), a_lo, max(a_hi, a_lo)) / torch.clamp(
        ay - ax, min=1).to(torch.float32)
    # the band in the C reference's f32 order (sigfish.c:396)
    m30 = m_a + 30.0
    top = m30 + 20.0
    botp = m30 - 20.0

    # P5: the jnn_core machine over the clamped pA tail, segs[0] only;
    # the in-range test and the step's index past ay are planes, and the
    # close-only updates run where some lane closes. A close (nC) or a
    # drop (nD) both reset the run: reset == closing
    sd1, win1, err1 = c32(v1.seg_dist), c32(v1.window), c32(v1.error)
    wst = torch.tensor(v1.window * v1.stall_len, **f32)
    i_rel_p = idx[:n_max] - ay[None, :]
    active = (i_rel_p >= 0) & (idx[:n_max] < n[None, :])
    pcl = _clamp(pa[:n_max])
    in_r_p = active & (pcl < top[None, :]) & (pcl > botp[None, :])
    out_p = (active & ~in_r_p).unbind(0)
    in_r_i = in_r_p.to(torch.int32).unbind(0)
    in_r_p, i_rel_p = in_r_p.unbind(0), i_rel_p.unbind(0)
    prev, have0, last0, have_l = zb, zb, zb, zb
    err, perr, c, start, s0e, l_e = zi, zi, zi, zi, zi, zi
    w = torch.full((B,), v1.corrector, **i32)
    # lanes without an adaptor answer -1 whatever their tail holds
    for k in range(int(torch.where(adaptor_ok, ay, n_max).min()) if B else 0, n_max):
        in_r = in_r_p[k]
        po = out_p[k] & prev
        e_ok = err < err1
        nB = po & e_ok
        closing = po & ~e_ok
        start = torch.where(in_r & ~prev, i_rel_p[k], start)
        grow = in_r | nB
        c2 = c + grow.to(torch.int32)
        w = w + in_r_i[k]
        perr2 = torch.where(in_r, zi, perr + nB.to(torch.int32))
        dec = grow & (c2 >= win1) & (c2 >= w) & (torch.remainder(c2, torch.clamp(w, min=1)) == 0)
        err2 = err + nB.to(torch.int32) - dec.to(torch.int32)
        if bool(closing.any()):
            nC = closing & ((c >= win1) | ((c.to(torch.float32) >= wst) & ~have_l))
            end = i_rel_p[k] - perr
            merge = nC & have_l & ((start - l_e) < sd1)
            s0e = torch.where(merge & last0, end, s0e)
            l_e = torch.where(merge, end, l_e)
            new = nC & ~merge
            first = new & ~have0
            s0e = torch.where(first, end, s0e)
            have0 = have0 | first
            last0 = torch.where(new, first, last0)
            l_e = torch.where(new, end, l_e)
            have_l = have_l | nC
            c2 = torch.where(closing, zi, c2)
            err2 = torch.where(closing, zi, err2)
            perr2 = torch.where(closing, zi, perr2)
        prev = in_r | (prev & ~closing)
        c, err, perr = c2, err2, perr2
    ok = adaptor_ok & have0 & (s0e > 0)
    return torch.where(ok, s0e + ay, -1).to(torch.int32)


def polya_end(
    sig_t: torch.Tensor,     # (S, B) i16, time-major, zero-padded
    nsamples: torch.Tensor,  # (B,) i32, each <= S
    raw_unit: torch.Tensor,  # (B,) f32
    offset: torch.Tensor,    # (B,) f32
    pore: int,
) -> torch.Tensor:
    """One polyA launch over a (S, B) batch: (B,) i32 polyA ends, -1 on
    failure. CPU tensors run polya_end_plain; CUDA tensors launch
    csrc/polya.cu on the current stream (counted in polya_end.launches)
    or raise."""
    if sig_t.dtype != torch.int16 or sig_t.dim() != 2:
        raise ValueError(f"polya_end: want int16 (S, B); got {sig_t.dtype} {tuple(sig_t.shape)}")
    S, B = sig_t.shape
    for name, t, dt in (("nsamples", nsamples, torch.int32), ("raw_unit", raw_unit, torch.float32),
                        ("offset", offset, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != (B,) or t.device != sig_t.device:
            raise ValueError(f"polya_end: {name} must be {dt} ({B},) on {sig_t.device}")
    if sig_t.device.type == "cpu":
        return polya_end_plain(sig_t, nsamples, raw_unit, offset, pore)
    if sig_t.device.type != "cuda":
        raise ValueError(f"polya_end: unsupported device {sig_t.device}")
    v2, v1 = pore_params(pore)
    # the kernel's rings copy 16-byte chunks of a row: lanes of 0 samples
    # pad the batch to lane_width(B)
    W = lane_width(B)
    sig_t, nsamples, raw_unit, offset = (pad_lanes(t, W) for t in (sig_t, nsamples, raw_unit,
                                                                   offset))
    out = torch.empty(W, dtype=torch.int32, device=sig_t.device)
    # the runtime launches on, and cudaFuncSetAttribute sets the shared
    # memory of, the calling thread's current device
    with torch.cuda.device(sig_t.device):
        err = _library().sf_polya(
            sig_t.data_ptr(), nsamples.data_ptr(), raw_unit.data_ptr(), offset.data_ptr(), S, W,
            v2.window, v2.std_scale, v2.seg_dist, v2.hi_thresh, v2.lo_thresh,
            v1.corrector, v1.seg_dist, v1.window, v1.error, v1.window * v1.stall_len,
            out.data_ptr(), torch.cuda.current_stream(sig_t.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"polya_end: CUDA launch failed (cudaError {err})")
    polya_end.launches += 1
    return out[:B]


polya_end.launches = 0

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """csrc/polya.cu's library, built on first use."""
    global _lib
    if _lib is None:
        from ..kernels.build import load_library

        lib = load_library("polya")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sf_polya.argtypes = [p, p, p, p, i, i, i, f, i, i, i, i, i, i, i, f, p, p]
        lib.sf_polya.restype = ctypes.c_int
        lib.sf_polya_ring_bytes.argtypes = []
        lib.sf_polya_ring_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def ring_bytes() -> int:
    """The dynamic shared memory a polya block takes (its two cursors'
    double-buffered rings), from the built library."""
    return int(_library().sf_polya_ring_bytes())


def polya_end_batch(
    signals: np.ndarray,       # (B, S) i16, zero-padded
    nsamples: np.ndarray,      # (B,) i32
    digitisation: np.ndarray,  # (B,) f64
    offset: np.ndarray,        # (B,) f64
    range_: np.ndarray,        # (B,) f64
    pore: int,
    device="cuda",
) -> np.ndarray:
    """Batched polyA-end detection on `device`: (B,) i64 raw-sample
    indices, -1 where the autodetect failed."""
    out = polya_end(*batch_tensors(signals, nsamples, digitisation, offset, range_, device), pore)
    return to_host(out).astype(np.int64)
