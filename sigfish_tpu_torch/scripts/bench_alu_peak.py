"""The card's ALU rate for the wavefront's op mix, and the wavefront
kernel's rate against it.

    python -m sigfish_tpu_torch.scripts.bench_alu_peak [--iters 16384] [--reps 20]

The counterpart of scripts/bench_vpu_peak.py. The sDTW wavefront is
min-plus: it issues no FMA and uses no tensor core, so the data-sheet
f32 peak (which counts an FMA as two operations) is no ceiling it can
reach. This script measures one:

  1. each mode of the probe kernel (csrc/alu_peak.cu, ops/alu_peak.py):
     add, min, select and roll as independent chains, and the wavefront
     step's 8-op recurrence as one chain (mix) and as two interleaved
     chains (mix2), at B=512 rows of Q=256, the wavefront's layout and
     occupancy; Gop/s from CUDA events over `reps` launches after a
     warm-up;
  2. the wavefront kernel (csrc/wavefront.cu) at B=512, Q=256 over the
     reference of chip_smoke.py's phase 4 (a seeded random 29,903-base
     sequence, both strands), in Gcell/s, in Gop/s at OPS_PER_CELL (7)
     operations per cell, and as a percent of the ceiling: the mix
     modes' best rate in wavefront steps, max(mix, mix2) Gstep/s, one
     step being one DP cell.

Gop/s per mode is in the JAX probe's units (ops/alu_peak.py), which
count a roll as one operation per value; it is not the card's
instruction issue rate. mix2 / mix above about 1.15 says the step's
recurrence latency, not the issue rate, limits the mix. It needs a CUDA
card and fails without one: there is no CPU fallback. The last line is
one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from ..ops.alu_peak import MODES, Q, STEPS_PER_ITER, alu_peak, gops, step_count
from ..ops.sdtw_wavefront import OPS_PER_CELL

B = 512
SMOKE_BASES = 29_903  # chip_smoke.py's phase-4 reference
SMOKE_SEED = 2019
W = 250


def _time_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over `reps` calls after one warm-up, from
    CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def measure_modes(iters: int, reps: int, seed: int = 0) -> dict[str, dict[str, float]]:
    """Each probe mode's ms per launch and Gop/s at (B, Q) = (512, 256),
    and for the mix modes their Gstep/s."""
    x = torch.from_numpy(np.random.default_rng(seed).random((B, Q), np.float32)).cuda()
    out = {}
    for mode in MODES:
        ms = _time_ms(lambda: alu_peak(x, mode, iters), reps)
        out[mode] = {"ms": ms, "gops": gops(mode, B, iters, ms / 1e3)}
        if mode in STEPS_PER_ITER:
            out[mode]["gsteps"] = step_count(mode, B, iters) / (ms / 1e3) / 1e9
    return out


def smoke_reference(n_bases: int = SMOKE_BASES, seed: int = SMOKE_SEED, q: int = Q):
    """chip_smoke.py's reference: a seeded random sequence as R9 DNA
    event tracks on both strands, padded as the pipeline pads them.
    Returns (ypad (1, D), rspad (1, D), D) for a q-wide query batch."""
    from ..models.genref import gen_ref
    from ..models.pore_model import MODEL_ID_DNA_R9, load_builtin_model
    from ..ops.layout import pad_tracks, prepare_wavefront_inputs

    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, n_bases))
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "ref.fa")
        with open(fa, "w") as f:
            f.write(f">synth_{n_bases}\n{seq}\n")
        ref = gen_ref(fa, load_builtin_model(MODEL_ID_DNA_R9), rna=False, query_size=W)
    tracks = [t for j in range(ref.num_ref) for t in (ref.forward[j], ref.reverse[j])]
    ref_cat, reset, _ = pad_tracks(tracks, ckpt=512, align=W)
    return prepare_wavefront_inputs(ref_cat, reset, q)


def measure_wavefront(reps: int, seed: int = 0) -> dict[str, float]:
    """The wavefront kernel's ms per launch and rates at B=512, Q=256
    over the smoke reference."""
    from ..ops.sdtw_wavefront import sdtw_wavefront

    ypad, rspad, D = smoke_reference()
    y, r = torch.from_numpy(ypad).cuda(), torch.from_numpy(rspad).cuda()
    q = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((B, Q)).astype(np.float32)
    ).cuda()
    ms = _time_ms(lambda: sdtw_wavefront(q, y, r, W - 1), reps)
    gcells = B * Q * D / (ms / 1e3) / 1e9
    return {"D": D, "ms": ms, "gcells": gcells, "gops": gcells * OPS_PER_CELL}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m sigfish_tpu_torch.scripts.bench_alu_peak")
    ap.add_argument("--iters", type=int, default=16384, help="loop-carried bodies per launch [16384]")
    ap.add_argument("--reps", type=int, default=20, help="timed launches per mode [20]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_alu_peak: no CUDA device; this probe measures the card and has no CPU fallback")

    card = torch.cuda.get_device_name(0)
    print(f"{card}: (B, Q) = ({B}, {Q}), {args.iters} iters per launch, {args.reps} launches per mode",
          flush=True)
    peaks = measure_modes(args.iters, args.reps)
    for mode, p in peaks.items():
        steps = f", {p['gsteps']:.1f} Gstep/s" if "gsteps" in p else ""
        print(f"  {mode:7s} {p['gops']:9.1f} Gop/s   ({p['ms']:.3f} ms per launch{steps})", flush=True)
    sol = max(peaks["mix"]["gsteps"], peaks["mix2"]["gsteps"])
    ratio = peaks["mix2"]["gops"] / peaks["mix"]["gops"]
    wf = measure_wavefront(args.reps)
    pct = 100.0 * wf["gcells"] / sol
    print(f"\nwavefront B={B} Q={Q} D={wf['D']}: {wf['ms']:.3f} ms per launch, "
          f"{wf['gcells']:.1f} Gcell/s = {wf['gops']:.1f} Gop/s at {OPS_PER_CELL} ops/cell")
    print(f"  vs the step chain's ceiling max(mix, mix2) = {sol:.1f} Gstep/s: {pct:.1f}%")
    print(f"  mix2/mix: {ratio:.3f} ("
          f"{'recurrence latency limits the mix' if ratio > 1.15 else 'issue rate limits the mix'})")
    result = {
        "card": card,
        "iters": args.iters,
        "peak_gops": {m: p["gops"] for m, p in peaks.items()},
        "peak_ms": {m: p["ms"] for m, p in peaks.items()},
        "ceiling_gsteps": sol,
        "mix2_over_mix": ratio,
        "wavefront_ms": wf["ms"],
        "wavefront_gcells_per_s": wf["gcells"],
        "wavefront_gops": wf["gops"],
        "pct_of_mix_peak": pct,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
