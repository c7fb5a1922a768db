"""The carry sDTW kernel at the chunked route's shape: ms per segment
launch by batch and warps per read, SM cycles per diagonal, and the
instructions its inner loop issues per diagonal.

    python -m sigfish_tpu_torch.scripts.bench_carry

1. Times ops/sdtw_wavefront.sdtw_wavefront_carry at Q=256 over one
   segment of Ds=32,000 diagonals (the chunked route's segment at W=250:
   the first one of chip_smoke.py's phase-4 reference, from a fresh
   state) for each batch in BATCHES and each warps-per-read instance, the
   median of REPS launches timed with CUDA events after a warm-up, and
   marks the instance carry_warps picks with *.
2. At B=512 times each instance again with every start lane 0: the same
   scores through the instance built for start lanes, which compares
   each row against the free-start row per cell where the main fold's
   instance (FS0, no start lanes) does not.
3. Prints SM cycles per diagonal at B=512 at the card's maximum SM
   clock, the number a read's chain of dependent steps is paid in.
4. Where the toolkit has cuobjdump, counts the SASS instructions of each
   carry instance's step loop (the shortest loop whose warp shuffles make
   whole steps) per diagonal, with the most frequent opcodes: beside
   the cycles per diagonal, whether a step is issue-bound or stall-bound.

It needs a CUDA card and fails without one: there is no CPU fallback.
The last line is one JSON object.
"""

from __future__ import annotations

import collections
import json
import re

import numpy as np
import torch

from ..ops import sdtw_wavefront as wfm
from .timing import median_ms, sm_clock_mhz

Q = 256
W = 250
DS = 32_000      # chunk_segment_diags(250)
SEED = 2
BATCHES = (16, 128, 512, 1024)
REPS = 5         # timed launches per cell


def carry_table(q: torch.Tensor, y: torch.Tensor, r: torch.Tensor, batches, start_lanes=False):
    """{B: {warps: ms}}: the carry kernel's median ms per segment launch
    of queries q[:B] over the segment (y, r) from a fresh state, at each
    warps instance built for q's width; with start_lanes, every start
    lane 0 passed explicitly."""
    Qq = q.shape[1]
    table = {}
    for B in batches:
        qt = q[:B].contiguous()
        state = wfm.carry_fresh_state(B, Qq, q.device)
        sl = torch.zeros(B, dtype=torch.int32, device=q.device) if start_lanes else None
        table[B] = {
            w: median_ms(lambda: wfm.sdtw_wavefront_carry(qt, y, r, *state, W - 1, sl, warps=w), REPS)
            for w in wfm.WARPS if Qq % (32 * w) == 0
        }
    return table


_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(0x[0-9a-f]+)")
_FUNC = re.compile(r"Function : (\S+)")
_INSTANCE = re.compile(r"wavefront_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])E")


def _functions(sass: str):
    """(mangled name, [(address, text)]) per function."""
    name, instrs = None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            if name:
                yield name, instrs
            name, instrs = m.group(1), []
            continue
        m = _INSTR.match(line)
        if m and name:
            instrs.append((int(m.group(1), 16), m.group(2)))
    if name:
        yield name, instrs


def _opcode(text: str) -> str:
    tok = text.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0] if tok else ""


def inner_loop(instrs, unit: int):
    """The opcodes of the step loop: the shortest backward-branch loop
    whose warp shuffles come in whole multiples of `unit` (a pass of
    whole steps, or of whole groups of four steps), or None. ptxas lays
    the tile loop out around the step loop, so loops overlap rather than
    nest, and a carry launch's last 1-3 steps have a loop of their own."""
    loops = []
    for addr, text in instrs:
        m = _TARGET.search(text)
        if m and int(m.group(1), 16) <= addr:
            lo = int(m.group(1), 16)
            ops = [o for o in (_opcode(t) for a, t in instrs if lo <= a <= addr) if o != "NOP"]
            n = sum(o.startswith("SHFL") for o in ops)
            if n and n % unit == 0:
                loops.append(ops)
    return min(loops, key=len) if loops else None


def sass_per_diagonal(sass: str, carry: bool = True) -> dict[str, dict]:
    """For each wavefront_kernel instance of the given mode, keyed
    "rows=R warps=W std=S fs0=F" (fs0=1: no start lanes, the chunked
    route's main fold): its step loop's instructions, shuffles, steps a
    pass (3 shuffles a step in groups of four split over warps, 4 a step
    with one warp), instructions per diagonal and the most frequent
    opcodes per diagonal."""
    out = {}
    for name, instrs in _functions(sass):
        m = _INSTANCE.search(name)
        if not m or (m.group(4) == "1") != carry:
            continue
        rows, warps, std, fs0 = int(m.group(1)), int(m.group(2)), m.group(3) == "1", m.group(5) == "1"
        per_step = 3 if warps > 1 else 4
        ops = inner_loop(instrs, 4 * per_step if warps > 1 else per_step)
        if ops is None:
            continue
        n_shfl = sum(o.startswith("SHFL") for o in ops)
        steps = n_shfl / per_step
        top = collections.Counter(o.split(".")[0] for o in ops).most_common(8)
        out[f"rows={rows} warps={warps} std={int(std)} fs0={int(fs0)}"] = {
            "rows": rows, "warps": warps, "std": std, "fs0": fs0, "loop_instructions": len(ops),
            "shuffles": n_shfl, "steps_per_pass": steps, "per_diagonal": len(ops) / steps,
            "top_per_diagonal": {o: n / steps for o, n in top},
        }
    return out


def segment(dev):
    """The first Ds diagonals of chip_smoke.py's phase-4 reference: the
    chunked route's first segment there."""
    from .bench_alu_peak import smoke_reference

    ypad, rspad, _ = smoke_reference(q=Q)
    return (torch.from_numpy(ypad[:, :DS].copy()).to(dev),
            torch.from_numpy(rspad[:, :DS].copy()).to(dev))


def main(y=None, r=None) -> dict:
    """Run the bench over the segment (y, r), or over segment() when
    none is given; prints the tables and returns them."""
    if not torch.cuda.is_available():
        raise SystemExit("bench_carry: no CUDA device; this bench measures the card and has no CPU fallback")
    dev = torch.device("cuda")
    if y is None:
        y, r = segment(dev)
    Ds = y.shape[1]
    q = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal((max(BATCHES), Q)).astype(np.float32)).to(dev)
    card = torch.cuda.get_device_name(0)
    print(f"carry ms per segment launch by warps per read, Q={Q} Ds={Ds} (median of {REPS}; "
          f"* = the instance carry_warps picks); {card}", flush=True)
    table = carry_table(q, y, r, BATCHES)
    for B, row in table.items():
        pick = wfm.carry_warps(B, Q)
        print(f"  B={B:4d}: " + "  ".join(
            f"warps={w}{'*' if w == pick else ' '} {t:8.3f}" for w, t in row.items()), flush=True)
    with_sl = carry_table(q, y, r, (512,), start_lanes=True)[512]
    print("  B= 512 with start lanes 0 (no FS0 instance): " + "  ".join(
        f"warps={w} {t:8.3f}" for w, t in with_sl.items()), flush=True)
    clk_now, clk_max = sm_clock_mhz()
    cycles = {w: t * 1e-3 * clk_max * 1e6 / Ds for w, t in table[512].items()}
    print(f"B=512 SM cycles per diagonal at the {clk_max:.0f} MHz maximum SM clock (now "
          f"{clk_now:.0f} MHz): " + ", ".join(f"warps={w} {c:.1f}" for w, c in cycles.items()))

    from ..kernels.build import sass

    text = sass("wavefront")
    per_diag = {}
    if text is None:
        print("SASS: cuobjdump absent, instructions per diagonal not counted")
    else:
        per_diag = {k: v for k, v in sass_per_diagonal(text).items()
                    if 32 * v["rows"] * v["warps"] == Q and not v["std"]}
        for k, v in per_diag.items():
            print(f"SASS carry {k} (Q={Q}): {v['per_diagonal']:.1f} instructions per diagonal "
                  f"({v['loop_instructions']} in a loop pass of {v['steps_per_pass']:g} steps); "
                  + ", ".join(f"{o} {n:.1f}" for o, n in v["top_per_diagonal"].items()))
    result = {
        "card": card, "Q": Q, "Ds": Ds,
        "table": {str(B): {str(w): t for w, t in row.items()} for B, row in table.items()},
        "b512_start_lanes": {str(w): t for w, t in with_sl.items()},
        "pick": {str(B): wfm.carry_warps(B, Q) for B in table},
        "clock_max_mhz": clk_max, "clock_now_mhz": clk_now,
        "cycles_per_diagonal_b512": {str(w): c for w, c in cycles.items()},
        "sass_per_diagonal": {k: v["per_diagonal"] for k, v in per_diag.items()},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
