"""The scan engine's kernel (csrc/scan.cu) at chip_smoke.py phase 13's
launch shapes, beside the scan.cu of older checkouts.

    python -m sigfish_tpu_torch.scripts.bench_scan [--old LABEL=DIR ...] [--reps 3]

Run from the root of a checkout on a machine with the card. It makes
phase 4's and phase 7's references with chip_smoke.py's generators and
seeds (each FASTA depends on its seed alone, so a few reads do) and
B=512 queries as phase 13 makes them, and launches the kernel at Q=256
over phase 4's R=60,416 columns and at Q=512 over phase 7's R=160,256:
each launch's median ms (CUDA events after a warm-up), its SM cycles a
column and a step at the maximum SM clock (a step: one column of every
lane of a warp; a warp sweeps its piece's columns plus 31), the pieces
each read's columns were split into, and its outputs held bit for bit
to one plain run; where the toolkit has cuobjdump, the SASS instructions
a step of each instance's step loop. With --old LABEL=DIR the scan.cu of the checkout DIR
(DIR/sigfish_tpu_torch/csrc/scan.cu) is built with the same flags and
timed in turns with the current one (old, new, new, old); its outputs
are held to the plain run bit for bit, or within rtol 2e-5 / atol 2e-4
where it sums in another order (the earlier warp-scan design). With --placement it
also builds each design with a probe (PROBE_REWRITES) and prints where
its long warps ran: the most and fewest on one SM and on one of an SM's
four schedulers.

It needs a CUDA card and fails without one. The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..ops import sdtw_scan as ss
from .timing import REPO, build_source, load_smoke, median_ms, same, sass_of, sm_clock_mhz

RTOL, ATOL = 2e-5, 2e-4   # another sum order: the JAX package's tolerance for this engine


def pieces(lib, reset: np.ndarray, B: int) -> list[tuple[int, int]]:
    """The column ranges [j0, j1) lib's kernel sweeps a read in, one warp
    each (csrc/scan.cu's scan_kernel: K near-equal ranges, each start
    snapped forward to its range's first reset, a range without one
    joined to the one before); one range where lib has no pieces."""
    R = reset.size
    K = lib.sf_sdtw_scan_pieces(B, R) if hasattr(lib, "sf_sdtw_scan_pieces") else 1
    if R == 0:
        return [(0, 0)]
    hits = np.flatnonzero(reset)

    def first(a, lim):
        i = np.searchsorted(hits, a)
        return int(hits[i]) if i < hits.size and hits[i] < lim else lim

    out = []
    for p in range(K):
        a0, a1 = p * R // K, (p + 1) * R // K
        j0 = 0 if p == 0 else first(a0, a1)
        if j0 == a1 and p > 0:
            continue  # no reset in its range: the piece before runs on
        out.append((j0, R if p == K - 1 else first(a1, R)))
    return out


def sass_per_step(text: str) -> dict:
    """For each scan_kernel instance of a cuobjdump listing, keyed "rows=R
    std=S": the SASS instructions a step of its unguarded step loop (the
    shortest loop whose shuffles come three a step) and its most frequent
    opcodes a step."""
    from .bench_carry import _functions, inner_loop

    out = {}
    for name, instrs in _functions(text):
        m = re.search(r"scan_kernelILi(\d+)ELb([01])E", name)
        ops = inner_loop(instrs, 3) if m else None
        if ops is None:
            continue
        steps = sum(o.startswith("SHFL") for o in ops) / 3
        top = collections.Counter(o.split(".")[0] for o in ops).most_common(8)
        out[f"rows={m.group(1)} std={m.group(2)}"] = {
            "per_step": len(ops) / steps, "top_per_step": {o: n / steps for o, n in top}}
    return out


# the placement probe: a copy of csrc/scan.cu whose kernel records, for
# each warp with columns to sweep, its SM (%smid), its warp slot on the SM
# (%warpid), its piece and its column count in a (B * K, 4) i32 buffer
PROBE_REWRITES = (
    ("namespace {\n", "__device__ int* scan_probe;\nnamespace {\n"),
    ("  w.run_all();\n",
     "  if (lane == 0 && scan_probe) {\n"
     "    unsigned sm, slot;\n"
     '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
     '    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));\n'
     "    int* o = scan_probe + 4 * (size_t)wid;\n"
     "    o[0] = (int)sm; o[1] = (int)slot; o[2] = p; o[3] = j1 - j0;\n"
     "  }\n  w.run_all();\n"),
    ('extern "C" int sf_sdtw_scan_pieces',
     'extern "C" int sf_scan_probe(int* p) {\n'
     "  return (int)cudaMemcpyToSymbol(scan_probe, &p, sizeof p);\n}\n\n"
     'extern "C" int sf_sdtw_scan_pieces'),
)


def probe_library(src: str, tag: str):
    """src (a scan.cu) with PROBE_REWRITES applied, built and declared."""
    import ctypes

    with open(src) as f:
        text = f.read()
    for a, b in PROBE_REWRITES:
        if a not in text:
            raise RuntimeError(f"{src}: the probe's rewrite finds no {a!r}")
        text = text.replace(a, b, 1)
    out = os.path.join(REPO, "build", f"{tag}.cu")
    with open(out, "w") as f:
        f.write(text)
    lib = ss._declare(build_source(out, tag))
    lib.sf_scan_probe.argtypes = [ctypes.c_void_p]
    return lib


def placement(lib, case: dict) -> dict:
    """Where lib's warps ran on one launch over case: for the warps that
    swept more than a quarter of the longest piece (the long ones), the
    most and fewest on one SM and on one scheduler (an SM's warp slots
    mod 4), and the SMs that held any."""
    q, oh, y, r = case["q"], case["oh"], case["y"], case["r"]
    B, R = q.shape[0], y.shape[0]
    K = lib.sf_sdtw_scan_pieces(B, R)
    buf = torch.full((B * K, 4), -1, dtype=torch.int32, device=q.device)
    lib.sf_scan_probe(buf.data_ptr())
    ss.launch(lib, q, oh, y, r)
    torch.cuda.synchronize()
    lib.sf_scan_probe(None)
    rec = buf.cpu().numpy()
    rec = rec[rec[:, 0] >= 0]
    long_ = rec[rec[:, 3] > rec[:, 3].max() // 4]
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    per_sm = np.bincount(long_[:, 0], minlength=n_sm)
    per_sched = np.bincount(long_[:, 0] * 4 + long_[:, 1] % 4, minlength=4 * n_sm)
    return {"warps": int(rec.shape[0]), "long_warps": int(long_.shape[0]),
            "sms_with_long": int((per_sm > 0).sum()),
            "long_per_sm_max": int(per_sm.max()), "long_per_sm_min": int(per_sm.min()),
            "long_per_scheduler_max": int(per_sched.max()),
            "long_per_scheduler_min": int(per_sched.min())}


def cases(smoke, work: str, dev) -> list[dict]:
    """Phase 13's two timed launches: B=512 seeded queries (one in ten
    clipped, the last of qlen 0) over phase 4's reference at Q=256 and
    over phase 7's at Q=512."""
    fa, bl, _ = smoke.make_workload(work, smoke.N_BASES, 8, smoke.SEED)
    st4, q4 = smoke.core_state(fa, bl)
    w7 = os.path.join(work, "rna")
    os.makedirs(w7)
    fa7, bl7, _ = smoke.make_rna_workload(w7, smoke.N7_TX, 8, smoke.SEED + 7)
    st7, q7 = smoke.core_state(fa7, bl7, **smoke.RNA_OPT)
    out = []
    for label, seed, st, Q, W in (("phase 4", smoke.SEED + 15, st4, q4, smoke.W),
                                  ("phase 7", smoke.SEED + 16, st7, q7, smoke.RNA_OPT["query_size"])):
        q, oh = smoke.scan_batch(seed, smoke.BATCH, Q, W, 10, dev)
        out.append(dict(label=label, Q=Q, q=q, oh=oh, reset_h=st.reset,
                        y=torch.from_numpy(st.ref_cat).to(dev), r=torch.from_numpy(st.reset).to(dev)))
    return out


def time_designs(designs: dict, case: dict, reps: int, clk_mhz: float, want=None) -> dict:
    """Each design's launch (designs: label -> library, "new" the current
    one) on case, timed in turns: the others, new, new, the others
    reversed; each output held to want (the plain run's, made here when
    None). Returns {label: {ms, ms_turns, cycles_per_column,
    cycles_per_step, pieces, bitwise_vs_plain, max_abs_err}} and
    "plain_ms" (None when want was given)."""
    q, oh, y, r = case["q"], case["oh"], case["y"], case["r"]
    B, R = q.shape[0], y.shape[0]
    plain_ms = None
    if want is None:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        want = ss.scan_plain(q, oh, y, r)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
    olds = [k for k in designs if k != "new"]
    turns = {k: [] for k in designs}
    for k in (*olds, "new", "new", *reversed(olds)):
        turns[k].append(median_ms(lambda: ss.launch(designs[k], q, oh, y, r), reps))
    out = {"plain_ms": plain_ms}
    for k, lib in designs.items():
        got = ss.launch(lib, q, oh, y, r)
        torch.cuda.synchronize()
        exact = same(got, want)
        err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1))
        close = all(torch.allclose(got[i], want[i], rtol=RTOL, atol=ATOL) for i in (0, 1))
        ms = float(np.mean(turns[k]))
        pc = pieces(lib, case["reset_h"], B)
        steps = max(b - a for a, b in pc) + 31
        out[k] = dict(ms=ms, ms_turns=turns[k], cycles_per_column=ms * 1e3 * clk_mhz / R,
                      cycles_per_step=ms * 1e3 * clk_mhz / steps, pieces=len(pc),
                      longest_piece=steps - 31, bitwise_vs_plain=exact, max_abs_err=err,
                      within_tolerance=close)
        del got
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--old", action="append", default=[], metavar="LABEL=DIR",
                    help="an older checkout whose csrc/scan.cu is timed beside the current one")
    ap.add_argument("--placement", action="store_true",
                    help="also print where each design's long warps ran (a probe build each)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_scan: needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    clk = sm_clock_mhz()[1]
    print(f"card: {smi}; max SM clock {clk:.0f} MHz")
    designs = {"new": ss._library()}
    sources = {"new": os.path.join(REPO, "sigfish_tpu_torch", "csrc", "scan.cu")}
    for spec in args.old:
        label, _, d = spec.partition("=")
        sources[label] = os.path.join(d, "sigfish_tpu_torch", "csrc", "scan.cu")
        designs[label] = ss._declare(build_source(sources[label], f"scan_{label}"))
    probes = {k: probe_library(src, f"scan_probe_{k}") for k, src in sources.items()
              if args.placement}
    smoke = load_smoke()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="bench_scan-", dir=os.path.join(REPO, "build"))
    result, ok = {"card": smi, "sm_clock_mhz": clk}, True
    for k, lib in designs.items():
        text = sass_of(lib._name)
        if text is None:
            break
        result.setdefault("sass", {})[k] = per = sass_per_step(text)
        for inst, v in per.items():
            print(f"SASS {k} {inst}: {v['per_step']:.1f} instructions a step of its unguarded "
                  "loop; " + ", ".join(f"{o} {n:.1f}" for o, n in v["top_per_step"].items()))
    try:
        for case in cases(smoke, work, dev):
            res = time_designs(designs, case, args.reps, clk)
            R = case["y"].shape[0]
            print(f"{case['label']}: B={case['q'].shape[0]}, Q={case['Q']}, R={R}, plain "
                  f"{res['plain_ms']:.1f} ms; card: {smi}")
            for k in designs:
                d = res[k]
                print(f"  {k}: {d['ms']:.3f} ms (turns {', '.join(f'{t:.3f}' for t in d['ms_turns'])}), "
                      f"{d['cycles_per_column']:.1f} SM cycles a column, {d['cycles_per_step']:.1f} a "
                      f"step of a warp ({d['pieces']} pieces, longest {d['longest_piece']}); "
                      f"bitwise_vs_plain={d['bitwise_vs_plain']} max_abs_err={d['max_abs_err']:.3g}")
                ok &= d["bitwise_vs_plain"] if k == "new" else d["within_tolerance"]
            for k, lib in probes.items():
                res[k]["placement"] = placement(lib, case)
                print(f"  {k} placement: {res[k]['placement']}")
            result[case["label"]] = res
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result))
    if not ok:
        raise SystemExit("bench_scan: a design's outputs differ from the plain run")


if __name__ == "__main__":
    main()
