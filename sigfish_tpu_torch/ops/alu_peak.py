"""ALU-rate probe for the wavefront's op mix: the CUDA kernel's wrapper
and its plain PyTorch version.

The counterpart of scripts/bench_vpu_peak.py's peak_kernel. On dummy
data x (B, 256) f32 it runs `iters` loop-carried bodies of one mode:

  add, min, select  CH = 4 chains that feed each other in pairs
                    (a0 = op(a0, a1); a1 = op(a1, a0)), so no chain folds
                    algebraically: 4 ops per value and iteration
  roll              each of the 4 chains rolled by one lane: 4 ops
  mix               the wavefront step (roll, 2 min, 2 select, sub, abs,
                    add) as one loop-carried chain: 8 ops
  mix2              two such chains, interleaved: 16 ops

with a_c = x + c, b = x * 0.5 and the mask x > 0.5 as inputs, and
returns a0 + a1 + a2 + a3. mix2 / mix says whether the step's
recurrence latency (mix2 faster) or the issue rate limits the mix.

The op counts are the JAX probe's units, which count the roll as one
operation per value; on the card a roll of a lane's 8 values is register
moves and one shuffle, so Gop/s in these units is no instruction rate.
The sweep is held to the mix modes in steps instead: one mix step is one
DP cell of the wavefront (the same 7 arithmetic operations, see
sdtw_wavefront.OPS_PER_CELL), so steps/s is the ceiling of its cells/s.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches csrc/alu_peak.cu or raises. The two agree bit for bit: the same
f32 operations in the same order, and min and select are exact.
"""

from __future__ import annotations

import ctypes

import torch

MODES = ("add", "min", "select", "roll", "mix", "mix2")
CH = 4  # chains
Q = 256  # the kernel's row width: 8 values per lane, as the wavefront at Q=256
# operations per value and iteration, as the JAX probe counts them
OPS_PER_ITER = {"add": CH, "min": CH, "select": CH, "roll": CH, "mix": 8, "mix2": 16}
# wavefront steps (DP cells) per value and iteration of the mix modes
STEPS_PER_ITER = {"mix": 1, "mix2": 2}


def op_count(mode: str, B: int, iters: int, q: int = Q) -> int:
    """Operations one launch of `mode` performs on a (B, q) plane."""
    return B * q * iters * OPS_PER_ITER[mode]


def gops(mode: str, B: int, iters: int, seconds_per_launch: float, q: int = Q) -> float:
    """The probe's rate in Gop/s from one launch's time."""
    return op_count(mode, B, iters, q) / seconds_per_launch / 1e9


def step_count(mode: str, B: int, iters: int, q: int = Q) -> int:
    """Wavefront steps (DP cells) one launch of a mix mode performs."""
    return B * q * iters * STEPS_PER_ITER[mode]


def _mix_step(a1, b2, b, m):
    up = torch.roll(a1, 1, dims=1)
    ld = torch.where(m, b, torch.minimum(a1, b2))
    local = torch.abs(a1 - b)
    anew = local + torch.minimum(up, ld)
    anew = torch.where(m, local, anew)
    return anew, up


def alu_peak_plain(x: torch.Tensor, mode: str, iters: int) -> torch.Tensor:
    """The plain version: the kernel's chains on (B, Q) tensors, in its
    op order. Runs on whatever device x lies on."""
    if mode not in MODES:
        raise ValueError(f"alu_peak: mode {mode!r} not in {MODES}")
    a = [x + float(c) for c in range(CH)]
    b = x * 0.5
    m = x > 0.5
    for _ in range(iters):
        if mode == "add":
            for c in range(0, CH, 2):
                a[c] = a[c] + a[c + 1]
                a[c + 1] = a[c + 1] + a[c]
        elif mode == "min":
            for c in range(0, CH, 2):
                a[c] = torch.minimum(a[c], a[c + 1])
                a[c + 1] = torch.minimum(a[c + 1], a[c])
        elif mode == "select":
            for c in range(0, CH, 2):
                a[c] = torch.where(m, a[c + 1], a[c])
                a[c + 1] = torch.where(m, a[c], a[c + 1])
        elif mode == "roll":
            a = [torch.roll(v, 1, dims=1) for v in a]
        else:
            for c in range(1 if mode == "mix" else 2):
                a[2 * c], a[2 * c + 1] = _mix_step(a[2 * c], a[2 * c + 1], b, m)
    acc = a[0]
    for v in a[1:]:
        acc = acc + v
    return acc


def alu_peak(x: torch.Tensor, mode: str, iters: int) -> torch.Tensor:
    """One probe launch over x (B, 256) f32; returns the (B, 256) sum of
    the chains. CPU tensors run alu_peak_plain; CUDA tensors launch the
    kernel (counted in alu_peak.launches) or raise."""
    if mode not in MODES:
        raise ValueError(f"alu_peak: mode {mode!r} not in {MODES}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != Q:
        raise ValueError(f"alu_peak: want float32 (B, {Q}); got {x.dtype} {tuple(x.shape)}")
    if iters < 0:
        raise ValueError(f"alu_peak: iters {iters} < 0")
    if x.device.type == "cpu":
        return alu_peak_plain(x, mode, iters)
    if x.device.type != "cuda":
        raise ValueError(f"alu_peak: unsupported device {x.device}")
    lib = _library()
    xc = x.contiguous()
    out = torch.empty_like(xc)
    # the runtime launches on the calling thread's current device
    with torch.cuda.device(xc.device):
        err = lib.sf_alu_peak(xc.data_ptr(), out.data_ptr(), xc.shape[0], Q, MODES.index(mode),
                              iters, torch.cuda.current_stream(xc.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alu_peak: CUDA launch failed (cudaError {err})")
    alu_peak.launches += 1
    return out


alu_peak.launches = 0

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """csrc/alu_peak.cu's library, built on first use."""
    global _lib
    if _lib is None:
        from ..kernels.build import load_library

        lib = load_library("alu_peak")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sf_alu_peak.argtypes = [p, p, i, i, i, i, p]
        lib.sf_alu_peak.restype = ctypes.c_int
        _lib = lib
    return _lib
