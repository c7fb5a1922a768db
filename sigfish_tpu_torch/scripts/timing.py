"""Timing helpers shared by chip_smoke.py and the benches: the median of
CUDA-event times, and the card's SM clock. Both need a CUDA card."""

from __future__ import annotations

import statistics
import subprocess

import torch


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
