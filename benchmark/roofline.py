"""The card's peak rates, read on the card.

An H100 issues at most 128 float32 instructions per SM and clock
(4 sub-partitions of 32 lanes); the least time of a kernel that does N
float32 operations is N over SMs x 128 x the highest SM clock. The SM
count comes from torch, the clock from nvidia-smi, so a card with fewer
SMs or a lower clock is held to its own peak.
"""

from __future__ import annotations

import subprocess

F32_PER_SM_CLOCK = 128


def max_sm_clock_mhz() -> float:
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return float(r.stdout.strip().splitlines()[0])


def f32_issue_rate() -> tuple[float, int, float]:
    """(float32 operations a second at the peak, SMs, max SM clock MHz)."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_clock_mhz()
    return sms * F32_PER_SM_CLOCK * mhz * 1e6, sms, mhz


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "unknown"
