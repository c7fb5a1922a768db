"""Helpers shared by chip_smoke.py and the benches: the median of
CUDA-event times, a call's peak memory, a kernel launch's per-case SM
clocks, the trainer kernels' sweep steps, the card's SM clock, the build
of another checkout's kernel source and its SASS, a byte comparison of
outputs, and chip_smoke.py loaded as a module. The timings need a CUDA
card, the build nvcc."""

from __future__ import annotations

import ctypes
import hashlib
import os
import statistics
import subprocess

import numpy as np
import torch


REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_smoke():
    """The checkout's chip_smoke.py as a module: its workload generators,
    seeds and sizes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same(a, b) -> bool:
    """Two sequences of tensors equal byte for byte, pairwise."""
    return all(u.dtype == v.dtype and u.shape == v.shape
               and torch.equal(u.contiguous().view(torch.uint8), v.contiguous().view(torch.uint8))
               for u, v in zip(a, b))


def median_ms(fn, reps: int) -> float:
    """Median device ms of fn() over `reps` calls after one warm-up,
    each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def sm_clock_mhz() -> tuple[float, float]:
    """(the SM clock now, its maximum) in MHz, as nvidia-smi reads them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    now, top = r.stdout.strip().splitlines()[0].split(",")
    return float(now), float(top)


def timed_call(fn, reps: int) -> tuple[float, float]:
    """(median ms of fn() over reps calls after a warm-up, MB of device
    memory its call's peak held above what was allocated before it)."""
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e6
    return median_ms(fn, reps), peak


def gap_case_steps(n: torch.Tensor, m: torch.Tensor, stripe_rows: int) -> np.ndarray:
    """Each case's sweep steps in csrc/gap_dtw.cu: its stripes of
    stripe_rows rows times (m + 31)."""
    n, m = n.long().cpu().numpy(), m.long().cpu().numpy()
    H = stripe_rows
    return np.where((n > 0) & (m > 0), (n + H - 1) // H * (m + 31), 0)


def banded_case_steps(n: torch.Tensor, m: torch.Tensor, band: torch.Tensor,
                      slack: int) -> np.ndarray:
    """Each case's sweep steps in csrc/banded_dtw.cu: over its 32-row
    stripes, the columns from the first row's band start to the last
    row's band end, plus 31."""
    out = []
    for nn, mm, bb in zip(n.tolist(), m.tolist(), band.tolist()):
        if nn <= 0 or mm <= 0:
            out.append(0)
            continue
        bw = max(bb, slack + 8)
        i0 = np.arange(0, nn, 32)
        i1 = np.minimum(i0 + 31, nn - 1)
        lo = np.maximum(0, i0 * mm // nn - bw)
        hi = np.minimum(mm, i1 * mm // nn + bw + 1)
        out.append(int((hi - lo + 31).sum()))
    return np.array(out)


def profile_launch(entry, args_fn, steps: np.ndarray, reps: int, what: str) -> dict:
    """One kernel's launch alone, entry(*args, stream) with (args, outputs,
    buffers) = args_fn(clocks) and clocks a (B, 4) int64 tensor the kernel
    fills (SM, start, sweep end, walk end): the median ms of reps launches
    (CUDA events, after a warm-up) and, from the clocks, the SM cycles of
    each case's sweep and walk, the sweep's cycles a step (the largest
    case's and the median over cases) and the cases an SM held at most."""
    dev = torch.device("cuda")
    B = steps.size
    clocks = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    args, out, hold = args_fn(clocks)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        err = entry(*args, stream)
        if err != 0:
            raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")

    ms = median_ms(launch, reps)
    c = clocks.cpu().numpy()
    live = steps > 0
    sweep, walk = (c[:, 2] - c[:, 1])[live], (c[:, 3] - c[:, 2])[live]
    per = sweep / steps[live]
    big = int(np.argmax(steps[live]))
    sms = np.bincount(c[live, 0].astype(np.int64))
    return {"launch_ms": ms, "sweep_cycles_max": int(sweep.max()),
            "walk_cycles_max": int(walk.max()), "cycles_per_step_largest": float(per[big]),
            "cycles_per_step_median": float(np.median(per)), "sms_used": int((sms > 0).sum()),
            "cases_per_sm_max": int(sms.max())}


def build_source(src: str, tag: str) -> ctypes.CDLL:
    """Compile the CUDA source src (an older checkout's csrc/<name>.cu)
    with the port's nvcc flags into build/kernels/<tag>-<hash>.so, unless
    that exists, and load it; the caller declares its C entry."""
    from ..kernels import build as kbuild

    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(kbuild.NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(kbuild.BUILD_DIR, f"{tag}-{h}.so")
    if not os.path.exists(so):
        os.makedirs(kbuild.BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run([kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-o", tmp, src],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def sass_of(so: str) -> str | None:
    """The SASS of a built library, as `cuobjdump -sass` prints it; None
    where the toolkit has no cuobjdump."""
    import shutil

    from ..kernels import build as kbuild

    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(kbuild.nvcc_path()),
                                                      "cuobjdump")
    if not os.path.exists(tool):
        return None
    r = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"cuobjdump failed for {so}:\n{r.stderr}")
    return r.stdout
