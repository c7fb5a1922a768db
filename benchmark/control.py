#!/usr/bin/env python3
"""The control of `correct`: the plain reference put in the mapper's
place with its DP in bfloat16, the precision below the float32 that the
configurations state, judged by check.py as a run's lines are.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's inputs as a run does, draws the sample
that a run whose window finished the whole file would draw, maps it with
the reference in float32 (the judge) and in bfloat16 (the control's
lines), and prints the compared numbers with their limits. The control
has to fail them. It does not run the mapper, so it does not need it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control(config: dict, traffic: dict, seed: int, scratch: str, device: str, dtype) -> dict:
    """The compared numbers of the control on one seed's inputs."""
    from benchmark import check
    from benchmark import traffic as gen
    from benchmark.reference import mapper

    data = gen.generate(config, traffic, seed, scratch)
    reads = data["reads"]
    picked = check.sample(reads, len(reads), seed)
    sub = [reads[i] for i in picked]
    expect, _ = mapper.map_reads(sub, data["contigs"], config["mapper"], device=device)
    got, _ = mapper.map_reads(sub, data["contigs"], config["mapper"], device=device, dtype=dtype)
    text = "".join(line for line in got.values() if line is not None)
    return check.judge(reads, picked, expect, [dict(text=text, fed=len(reads), done=len(reads))])


def main(argv=None) -> int:
    import torch

    from benchmark import check
    from benchmark.run import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    spec = resolve(ROOT, args.workload)
    scratch = os.path.join(ROOT, "build", "benchmark", "control", args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        nums = control(spec["config"], spec["traffic"], seed, scratch, "cuda", torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": "bfloat16",
                          "checks": {k: {"value": v, "limit": check.LIMITS[k]} for k, v in nums.items()},
                          "fails": not check.verdict(nums), "seconds": round(time.time() - t0, 3)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
