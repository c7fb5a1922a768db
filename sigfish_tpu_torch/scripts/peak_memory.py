"""Peak device memory of chip_smoke.py's phase-6 run, repeated in one
process.

    python -m sigfish_tpu_torch.scripts.peak_memory

Run from the root of a checkout (it imports that checkout's
chip_smoke.py for phase 6's workload and its run_port helper). It makes
phase 6's workload (a seeded random reference of E. coli K-12's length,
both strands, 1,536 reads in 3 batches of 512, one in ten clipped), then
runs run_dtw over it RUNS times as the CLI runs it (batches overlapped:
one batch's drain beside the next batch's submission) and once with
--profile-cpu (one batch in flight), each from reset peak statistics,
and prints each run's torch.cuda.max_memory_allocated and seconds. The
overlapped runs' spread shows whether two batches' device buffers meet.
It needs a CUDA card and fails without one. The last line is one JSON
object.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUNS = 4


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("peak_memory: no CUDA device; this probe measures the card")
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    work = tempfile.mkdtemp(prefix="peak_memory_")
    try:
        fa, bl, _ = cs.make_workload(work, cs.ECOLI_BASES, cs.N6_READS, cs.SEED + 6)
        state, _ = cs.core_state(fa, bl)
        runs = []
        for i in range(RUNS + 1):
            profile = i == RUNS
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, core, dt = cs.run_port(fa, bl, "cuda", state=state, profile=profile)
            peak = torch.cuda.max_memory_allocated() / 1e9
            runs.append({"profile": profile, "peak_gb": peak, "seconds": dt,
                         "reads": core.total_reads, "routes": core.routes})
            print(f"run {i} ({'--profile-cpu' if profile else 'overlapped'}): peak "
                  f"{peak:.3f} GB, {dt:.3f} s, routes {core.routes}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result = {"repo": REPO, "card": torch.cuda.get_device_name(0), "runs": runs}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
