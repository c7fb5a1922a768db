"""The carry sDTW kernel at the chunked route's shape: ms per segment
launch by batch, body and warps per read, SM cycles per diagonal, and
the instructions its inner loop issues per diagonal.

    python -m sigfish_tpu_torch.scripts.bench_carry

1. Times ops/sdtw_wavefront.sdtw_wavefront_carry at Q=256 over one
   segment of Ds=32,000 diagonals (the chunked route's segment at W=250:
   the first one of chip_smoke.py's phase-4 reference, from a fresh
   state) for each batch in BATCHES and each warps-per-read instance, the
   median of REPS launches timed with CUDA events after a warm-up, and
   marks the instance carry_warps picks with *: the flag-aware instances
   (the FS0 one, no start lanes) and the flag-free body (flags=False,
   over the same reference values: it reads no flag, so its work is the
   same).
2. Times both bodies again with CLIPPED_LANES as the start lanes of the
   batch's first reads (one clipped read of each residue a lane's rows
   give, in the lower and the upper warp, the rest 0), for each batch:
   the flag-aware instance built for start lanes, and the flag-free body,
   whose warps without the free-start row run the body without it. At
   B=512 it also times the flag-aware instance with every start lane 0.
3. Prints SM cycles per diagonal at B=512 at the card's maximum SM
   clock, the number a read's chain of dependent steps is paid in.
4. Where the toolkit has cuobjdump, counts the SASS instructions of each
   carry instance's step loop (the shortest loop whose warp shuffles make
   whole steps) per diagonal, with the most frequent opcodes, and of the
   flag-free body's step loops (one a warp's pair of free-start and
   emitted registers) the fewest and the most: beside the cycles per
   diagonal, whether a step is issue-bound or stall-bound.

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
from .timing import median_ms, sass_of, sm_clock_mhz

Q = 256
W = 250
DS = 32_000      # chunk_segment_diags(250)
SEED = 2
BATCHES = (16, 128, 512, 1024)
REPS = 5         # timed launches per cell
# the start lanes of a batch's first reads in the clipped tables: every
# residue mod 4 rows a lane, in warp 0 and in the upper warp at 2 warps
# (rows 128-255, the emitted row 249's), and the largest, 249
CLIPPED_LANES = (1, 2, 3, 4, 129, 130, 131, 132, 200, 249)


def start_lanes_of(B: int, kind: str | None, device):
    """None for kind None; else (B,) i32: every lane 0 ("zeros"), or
    CLIPPED_LANES on the first reads and 0 on the rest ("clipped")."""
    if kind is None:
        return None
    sl = torch.zeros(B, dtype=torch.int32)
    if kind == "clipped":
        n = min(B, len(CLIPPED_LANES))
        sl[:n] = torch.tensor(CLIPPED_LANES[:n], dtype=torch.int32)
    return sl.to(device)


def carry_table(q: torch.Tensor, y: torch.Tensor, r: torch.Tensor, batches, start_lanes=None,
                flags=True):
    """{B: {warps: ms}}: the carry kernel's median ms per segment launch
    of queries q[:B] over the segment (y, r) from a fresh state, at each
    warps instance of the body built for q's width: the flag-aware
    instances, or with flags=False the flag-free body (r must hold no
    flag then); start_lanes a start_lanes_of kind."""
    Qq = q.shape[1]
    table = {}
    for B in batches:
        qt = q[:B].contiguous()
        state = wfm.carry_fresh_state(B, Qq, q.device)
        sl = start_lanes_of(B, start_lanes, q.device)
        table[B] = {
            w: median_ms(lambda: wfm.sdtw_wavefront_carry(qt, y, r, *state, W - 1, sl, warps=w,
                                                          flags=flags), REPS)
            for w in wfm.WARPS
            if Qq % (32 * w) == 0 and (flags or wfm.noflag_built(Qq, w))
        }
    return table


_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(0x[0-9a-f]+)")
_FUNC = re.compile(r"Function : (\S+)")
_INSTANCE = re.compile(r"wavefront_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])E")
_NOFLAG = re.compile(r"carry_noflag_kernelILi(\d+)ELi(\d+)E")


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
    loops = [ops for ops in _backward_loops(instrs)
             if (n := sum(o.startswith("SHFL") for o in ops)) and n % unit == 0]
    return min(loops, key=len) if loops else None


def _backward_loops(instrs):
    """The opcodes of every backward-branch loop, NOPs left out."""
    for addr, text in instrs:
        m = _TARGET.search(text)
        if m and int(m.group(1), 16) <= addr:
            lo = int(m.group(1), 16)
            yield [o for o in (_opcode(t) for a, t in instrs if lo <= a <= addr) if o != "NOP"]


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


def sass_noflag(sass: str) -> dict[str, dict]:
    """For each instance of the flag-free body, keyed "rows=R warps=W":
    its step loops, the loops of exactly one pass of U = max(4, R) steps
    (2U shuffles: 2 a step), one a combination of free-start register,
    emitted register and handoff; the fewest and the most instructions
    per diagonal among them, and the most frequent opcodes per diagonal
    of the shortest."""
    out = {}
    for name, instrs in _functions(sass):
        m = _NOFLAG.search(name)
        if not m:
            continue
        rows, warps = int(m.group(1)), int(m.group(2))
        steps = max(4, rows)
        loops = [ops for ops in _backward_loops(instrs)
                 if sum(o.startswith("SHFL") for o in ops) == 2 * steps]
        if not loops:
            continue
        per = sorted(len(ops) / steps for ops in loops)
        top = collections.Counter(o.split(".")[0] for o in min(loops, key=len)).most_common(8)
        out[f"rows={rows} warps={warps}"] = {
            "rows": rows, "warps": warps, "loops": len(loops), "per_diagonal_min": per[0],
            "per_diagonal_max": per[-1], "top_per_diagonal": {o: n / steps for o, n in top},
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
    r0 = torch.zeros_like(r)  # the flag-free body's promise: no flag set
    table = carry_table(q, y, r, BATCHES)
    table_nf = carry_table(q, y, r0, BATCHES, flags=False)
    clipped = carry_table(q, y, r, BATCHES, "clipped")
    clipped_nf = carry_table(q, y, r0, BATCHES, "clipped", flags=False)
    for label, tab in (("flag-aware, no start lanes (FS0)", table),
                       ("flag-free, no start lanes", table_nf),
                       (f"flag-aware, start lanes {CLIPPED_LANES}", clipped),
                       (f"flag-free, start lanes {CLIPPED_LANES}", clipped_nf)):
        print(f" {label}:", flush=True)
        for B, row in tab.items():
            pick = wfm.carry_warps(B, Q)
            print(f"  B={B:4d}: " + "  ".join(
                f"warps={w}{'*' if w == pick else ' '} {t:8.3f}" for w, t in row.items()), flush=True)
    with_sl = carry_table(q, y, r, (512,), "zeros")[512]
    print("  B= 512 flag-aware, start lanes 0 (no FS0 instance): " + "  ".join(
        f"warps={w} {t:8.3f}" for w, t in with_sl.items()), flush=True)
    clk_now, clk_max = sm_clock_mhz()

    def cycles(row):
        return {w: t * 1e-3 * clk_max * 1e6 / Ds for w, t in row.items()}

    print(f"B=512 SM cycles per diagonal at the {clk_max:.0f} MHz maximum SM clock (now "
          f"{clk_now:.0f} MHz): flag-aware FS0 " + ", ".join(
              f"warps={w} {c:.1f}" for w, c in cycles(table[512]).items())
          + "; flag-free " + ", ".join(f"warps={w} {c:.1f}" for w, c in cycles(table_nf[512]).items())
          + "; flag-free, clipped " + ", ".join(
              f"warps={w} {c:.1f}" for w, c in cycles(clipped_nf[512]).items()))

    from ..kernels.build import build

    text = sass_of(build("wavefront")[0])
    per_diag, per_diag_nf = {}, {}
    if text is None:
        print("SASS: cuobjdump absent, instructions per diagonal not counted")
    else:
        per_diag = {k: v for k, v in sass_per_diagonal(text).items()
                    if 32 * v["rows"] * v["warps"] == Q and not v["std"]}
        for k, v in per_diag.items():
            print(f"SASS carry {k} (Q={Q}): {v['per_diagonal']:.1f} instructions per diagonal "
                  f"({v['loop_instructions']} in a loop pass of {v['steps_per_pass']:g} steps); "
                  + ", ".join(f"{o} {n:.1f}" for o, n in v["top_per_diagonal"].items()))
        per_diag_nf = {k: v for k, v in sass_noflag(text).items()
                       if 32 * v["rows"] * v["warps"] == Q}
        for k, v in per_diag_nf.items():
            print(f"SASS carry flag-free {k} (Q={Q}): {v['per_diagonal_min']:.2f} to "
                  f"{v['per_diagonal_max']:.2f} instructions per diagonal over its {v['loops']} "
                  "step loops; the shortest: "
                  + ", ".join(f"{o} {n:.2f}" for o, n in v["top_per_diagonal"].items()))

    def jtab(tab):
        return {str(B): {str(w): t for w, t in row.items()} for B, row in tab.items()}

    result = {
        "card": card, "Q": Q, "Ds": Ds,
        "table": jtab(table), "table_noflag": jtab(table_nf),
        "table_clipped": jtab(clipped), "table_clipped_noflag": jtab(clipped_nf),
        "clipped_lanes": list(CLIPPED_LANES),
        "b512_start_lanes": {str(w): t for w, t in with_sl.items()},
        "pick": {str(B): wfm.carry_warps(B, Q) for B in table},
        "clock_max_mhz": clk_max, "clock_now_mhz": clk_now,
        "cycles_per_diagonal_b512": {str(w): c for w, c in cycles(table[512]).items()},
        "cycles_per_diagonal_b512_noflag": {str(w): c for w, c in cycles(table_nf[512]).items()},
        "sass_per_diagonal": {k: v["per_diagonal"] for k, v in per_diag.items()},
        "sass_per_diagonal_noflag": {k: [v["per_diagonal_min"], v["per_diagonal_max"]]
                                     for k, v in per_diag_nf.items()},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
