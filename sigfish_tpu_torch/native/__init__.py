"""ctypes loader for the native host kernels (csrc/sigfish_native.cpp).

Builds on first import with g++ (cached by source mtime); every entry
point has a pure-Python fallback in ops/, so import never fails hard --
`available` reports whether the fast path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "sigfish_native.cpp")
# built into the checkout's build/ directory (git-ignored), never beside
# the source
_SO = os.path.join(
    os.path.dirname(os.path.dirname(_HERE)), "build", "native",
    "_sigfish_native.so",
)

_lib = None


def _build() -> bool:
    # compile to a per-process name and rename into place, so concurrent
    # first imports (test workers) never load a half-written library
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        cmd = [
            "g++", "-O3", "-march=native", "-ffp-contract=off", "-fno-math-errno", "-shared", "-fPIC",
            "-o", tmp, _SRC, "-lz", "-ldeflate", "-lzstd",
        ]
        if os.environ.get("SIGFISH_TPU_ASAN"):
            # sanitizer build (ref Makefile:29-32 `make asan=1`); run
            # python under LD_PRELOAD=$(g++ -print-file-name=libasan.so)
            cmd[1:1] = ["-fsanitize=address,undefined", "-g"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            # a host without the libdeflate / zstd headers: build the rest
            # (events, z-score, DP, backtrack); zlib/zstd-wrapped records
            # then decode in Python
            cmd = [c for c in cmd if c not in ("-ldeflate", "-lzstd")]
            cmd.insert(1, "-DSF_NO_DEFLATE_ZSTD")
            r2 = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if r2.returncode != 0:
                sys.stderr.write(f"[native] build failed:\n{r.stderr}\n{r2.stderr}\n")
                return False
            sys.stderr.write(
                "[native] built without libdeflate/zstd: wrapped BLOW5 records decode in Python\n"
            )
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # compiler missing etc.
        sys.stderr.write(f"[native] build error: {e}\n")
        return False


def _load():
    global _lib
    if os.environ.get("SIGFISH_TPU_NO_NATIVE"):
        # force the pure-Python oracle fallbacks (tests the degraded
        # path a host without a working g++ would take)
        return None
    if _lib is not None:
        return _lib
    need = (not os.path.exists(_SO)) or (
        os.path.getmtime(_SO) < os.path.getmtime(_SRC)
    )
    if need and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError as e:
        sys.stderr.write(f"[native] load error: {e}\n")
        return None

    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.sf_subsequence.argtypes = [f32p, ctypes.c_int32, f32p, ctypes.c_int32, f32p]
    lib.sf_subsequence.restype = None
    lib.sf_std_dtw.argtypes = [
        f32p, ctypes.c_int32, f32p, ctypes.c_int32, f32p, ctypes.c_int32
    ]
    lib.sf_std_dtw.restype = None
    lib.sf_path.argtypes = [f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p]
    lib.sf_path.restype = ctypes.c_int32
    lib.sf_subsequence_path.argtypes = lib.sf_path.argtypes
    lib.sf_subsequence_path.restype = ctypes.c_int32
    lib.sf_detect_events.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
        ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.sf_detect_events.restype = ctypes.c_int32
    lib.sf_zscore.argtypes = [f32p, ctypes.c_int64]
    lib.sf_zscore.restype = None
    lib.sf_meanf.argtypes = [f32p, ctypes.c_int64]
    lib.sf_meanf.restype = ctypes.c_float
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.sf_jnn_segments.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_double, ctypes.c_int64, i64p,
        ctypes.c_int64,
    ]
    lib.sf_jnn_segments.restype = ctypes.c_int64
    lib.sf_jnn_core.argtypes = [
        f64p, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
        ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.sf_jnn_core.restype = ctypes.c_int64
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sf_blow5_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64,
    ]
    lib.sf_blow5_decode.restype = ctypes.c_int64
    lib.sf_subsequence_backtrack.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sf_subsequence_backtrack.restype = ctypes.c_int32
    lib.sf_jnnv2.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.sf_jnnv2.restype = None
    lib.sf_subsequence_lastrow.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sf_subsequence_lastrow.restype = None
    lib.sf_std_lastrow.argtypes = lib.sf_subsequence_lastrow.argtypes
    lib.sf_std_lastrow.restype = None
    lib.sf_pa_from_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_void_p,
    ]
    lib.sf_pa_from_i16.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def subsequence_cost(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Exact scalar-order subsequence DP (n, m). None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    cost = np.empty((x.size, y.size), np.float32)
    lib.sf_subsequence(x, x.size, y, y.size, cost.reshape(-1))
    return cost

def std_dtw_cost(x: np.ndarray, y: np.ndarray, squared: bool = False) -> np.ndarray:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    cost = np.empty((x.size, y.size), np.float32)
    lib.sf_std_dtw(x, x.size, y, y.size, cost.reshape(-1), int(squared))
    return cost


def subsequence_path(cost: np.ndarray, starty: int):
    """Backtrack + row-0 stutter strip; returns (px, py) int arrays."""
    lib = _load()
    if lib is None:
        return None
    n, m = cost.shape
    px = np.empty(n + m + 2, np.int32)
    py = np.empty(n + m + 2, np.int32)
    cost = np.ascontiguousarray(cost, np.float32)
    k = lib.sf_subsequence_path(cost.reshape(-1), n, m, int(starty), px, py)
    return px[:k].astype(np.int64), py[:k].astype(np.int64)


def path(cost: np.ndarray, starty: int):
    lib = _load()
    if lib is None:
        return None
    n, m = cost.shape
    px = np.empty(n + m + 2, np.int32)
    py = np.empty(n + m + 2, np.int32)
    cost = np.ascontiguousarray(cost, np.float32)
    k = lib.sf_path(cost.reshape(-1), n, m, int(starty), px, py)
    return px[:k].astype(np.int64), py[:k].astype(np.int64)


def subsequence_backtrack(x: np.ndarray, y: np.ndarray, starty: int,
                          std: bool = False):
    """Fused DP window recompute + greedy backtrack (one native call,
    no host-side cost matrix). Returns (px, py) or None."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    n, m = x.size, y.size
    if n < 1 or m < 1:
        # the C kernels read x[0]/y[0] unconditionally; an empty query
        # or window must fail loudly, not corrupt the heap (fuzz 31025)
        raise ValueError(f"subsequence_backtrack: empty input (n={n}, m={m})")
    px = np.empty(n + m + 2, np.int32)
    py = np.empty(n + m + 2, np.int32)
    k = lib.sf_subsequence_backtrack(
        x.ctypes.data, n, y.ctypes.data, m, int(starty), int(std),
        px.ctypes.data, py.ctypes.data,
    )
    if k < 0:
        return None
    return px[:k].astype(np.int64), py[:k].astype(np.int64)


def subsequence_lastrow(x: np.ndarray, y: np.ndarray,
                        out: np.ndarray | None = None):
    """Last DP row with O(m) memory (the native CPU engine's scoring
    pass). Returns the (m,) row or None."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    if out is None:
        out = np.empty(y.size, np.float32)
    scratch = np.empty(y.size, np.float32)
    lib.sf_subsequence_lastrow(
        x.ctypes.data, x.size, y.ctypes.data, y.size,
        out.ctypes.data, scratch.ctypes.data,
    )
    return out


def std_lastrow(x: np.ndarray, y: np.ndarray,
                out: np.ndarray | None = None):
    """Last row of the boundary-anchored standard DTW (--dtw-std) with
    O(m) memory, exact scalar order (cdtw.c:70-94). Returns the (m,)
    row or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    if out is None:
        out = np.empty(y.size, np.float32)
    scratch = np.empty(y.size, np.float32)
    lib.sf_std_lastrow(
        x.ctypes.data, x.size, y.ctypes.data, y.size,
        out.ctypes.data, scratch.ctypes.data,
    )
    return out


def zscore_inplace(x: np.ndarray) -> bool:
    """Sequential-f32 population z-score (reference summation order,
    genref.c:23-47 / sigfish.c:483-502). Returns False if unavailable."""
    lib = _load()
    if lib is None:
        return False
    assert x.dtype == np.float32 and x.flags["C_CONTIGUOUS"]
    lib.sf_zscore(x, x.size)
    return True


def meanf_seq(x: np.ndarray) -> float | None:
    """Sequential-f32 mean (reference stat.h:17 meanf). None if the
    native library is unavailable -- callers fall back to a Python loop
    with the identical accumulation order."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    return float(lib.sf_meanf(x, x.size))


def blow5_decode(blob: bytes, rec_press: str, sig_press: str):
    """Decode one BLOW5 record blob. Returns (read_id, read_group,
    digitisation, offset, range, sampling_rate, signal i16) or None when
    the native path can't handle the compression combination."""
    lib = _load()
    if lib is None:
        return None
    rp = {"none": 0, "zlib": 1, "zstd": 2}.get(rec_press)
    sp = {"none": 0, "svb-zd": 1, "zlib": 250, "zstd": 251}.get(sig_press)
    if rp is None or sp is None:
        return None
    buf = np.frombuffer(blob, dtype=np.uint8)
    cap = max(len(blob) * 16, 4096)
    retried = False
    while True:
        sig = np.empty(cap, np.int16)
        rid = ctypes.create_string_buffer(1024)
        rg = ctypes.c_uint32(0)
        meta = np.empty(4, np.float64)
        n = lib.sf_blow5_decode(
            buf.ctypes.data, buf.size, rp, sp, rid, 1024,
            ctypes.byref(rg), meta.ctypes.data, sig.ctypes.data, cap,
        )
        if n >= 0:
            return (
                rid.value.decode("ascii"), int(rg.value),
                float(meta[0]), float(meta[1]), float(meta[2]), float(meta[3]),
                sig[:n].copy(),
            )
        # -2 - needed = capacity miss: retry ONCE with the exact size.
        # -1 = malformed/unsupported: fail fast (no growth loop burning
        # 128 MB allocations on records the decoder can never accept).
        if n <= -2 and not retried:
            cap = -(n + 2)
            retried = True
            continue
        return None


def pa_from_i16(sig: np.ndarray, digitisation: float, offset: float,
                range_: float):
    """Fused ADC->pA conversion (exact f32 op order of to_pa); None if
    the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    sig = np.ascontiguousarray(sig, np.int16)
    out = np.empty(sig.size, np.float32)
    lib.sf_pa_from_i16(
        sig.ctypes.data, sig.size, float(digitisation), float(offset),
        float(range_), out.ctypes.data,
    )
    return out


def jnnv2(sig_i16: np.ndarray, window: int, std_scale: float,
          seg_dist: int, hi_thresh: int, lo_thresh: int):
    """Full adaptor finder, bit-exact with jnn.c:100-180 (running-sum
    rolling mean, sequential-f32 stats). Returns (x, y) or None."""
    lib = _load()
    if lib is None:
        return None
    sig = np.ascontiguousarray(sig_i16, np.int16)
    out = np.empty(2, np.int64)
    lib.sf_jnnv2(sig.ctypes.data, sig.size, window, std_scale,
                 seg_dist, hi_thresh, lo_thresh, out.ctypes.data)
    return int(out[0]), int(out[1])


def jnn_segments(t: np.ndarray, bot: float, seg_dist: int):
    """Below-threshold segment extraction (adaptor finder inner loop).

    The C side returns -1 when the segment buffer is too small; retry
    with a doubled cap (mirrors the reference's realloc, jnn.c:141-145).
    """
    lib = _load()
    if lib is None:
        return None
    t = np.ascontiguousarray(t, np.float64)
    cap = 4096
    while True:
        out = np.empty(2 * cap, np.int64)
        n = lib.sf_jnn_segments(t, t.size, float(bot), int(seg_dist), out, cap)
        if n >= 0:
            return out[: 2 * n].reshape(-1, 2)
        cap *= 2


def jnn_core_segments(sig: np.ndarray, top: float, bot: float, corrector: int,
                      seg_dist: int, window: int, stall_len: float, error: int,
                      first_only: bool = False):
    """Error-tolerant in-range run detector (jnn.c:191-279). Grows the
    segment buffer on overflow (C side returns -1). With first_only the
    C side stops as soon as segs[0] is provably final and the return is
    (segments, finalized) -- finalized=False means the scan hit the end
    of `sig` without the early-stop proof firing (exact only if `sig`
    was the whole signal)."""
    lib = _load()
    if lib is None:
        return None
    sig = np.ascontiguousarray(sig, np.float64)
    cap = 4096
    fin = ctypes.c_int32(0)
    while True:
        out = np.empty(2 * cap, np.int64)
        n = lib.sf_jnn_core(
            sig, sig.size, float(top), float(bot), int(corrector),
            int(seg_dist), int(window), float(stall_len), int(error), out, cap,
            1 if first_only else 0, ctypes.byref(fin),
        )
        if n >= 0:
            segs = out[: 2 * n].reshape(-1, 2)
            return (segs, bool(fin.value)) if first_only else segs
        cap *= 2


_EV_SCRATCH: dict = {}


def detect_events(signal_pa: np.ndarray, rna: bool = False,
                  exact_limit: int | None = None):
    """Native event segmentation; returns (start u64, length f32,
    mean f32, stdv f32) or None if unavailable. With exact_limit, a
    fifth element n_safe is appended: the count of leading events
    bit-identical to the full-signal run when signal_pa is a truncated
    prefix (see ops/events.py detect_events_prefix)."""
    lib = _load()
    if lib is None:
        return None
    from ..ops.events import DNA_PARAMS, RNA_PARAMS

    p = RNA_PARAMS if rna else DNA_PARAMS
    sig = np.ascontiguousarray(signal_pa, np.float32)
    n = sig.size
    cap = n + 2
    # reuse output scratch across calls (4 x ~1 MB fresh allocations per
    # RNA read otherwise; only the first k events are copied out below).
    # Thread-keyed: the pipeline pool calls this concurrently.
    import threading

    key = threading.get_ident()
    bufs = _EV_SCRATCH.get(key)
    if bufs is None or bufs[0].size < cap:
        bufs = (
            np.empty(max(cap, 1 << 16), np.int64),
            np.empty(max(cap, 1 << 16), np.float32),
            np.empty(max(cap, 1 << 16), np.float32),
            np.empty(max(cap, 1 << 16), np.float32),
        )
        _EV_SCRATCH[key] = bufs
    ev_start, ev_len, ev_mean, ev_stdv = bufs
    n_safe = ctypes.c_int32(0)
    k = lib.sf_detect_events(
        sig.ctypes.data, n,
        p["window_length1"], p["window_length2"],
        p["threshold1"], p["threshold2"], p["peak_height"],
        ev_start.ctypes.data, ev_len.ctypes.data,
        ev_mean.ctypes.data, ev_stdv.ctypes.data,
        n if exact_limit is None else int(exact_limit),
        ctypes.byref(n_safe),
    )
    if k < 0:
        return None
    out = (
        ev_start[:k].astype(np.uint64),
        ev_len[:k].copy(),
        ev_mean[:k].copy(),
        ev_stdv[:k].copy(),
    )
    return out if exact_limit is None else out + (int(n_safe.value),)
