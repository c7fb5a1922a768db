"""The trainer's two E-step kernels (csrc/gap_dtw.cu, csrc/banded_dtw.cu)
at chip_smoke.py phase 12's iteration-1 batches: each call's ms, peak
device memory and SM cycles a step, held bit for bit to the plain
versions.

    python -m sigfish_tpu_torch.scripts.bench_train_dtw [--reps 5] [--warps 1,2,3,4]

Run from the root of a checkout on a machine with the card. It makes
phase 4's and phase 7's workloads with chip_smoke.py's generators and
seeds, loads phase 12's cases (the first 256 DNA reads, the first 512
trimmed RNA reads) and runs fit_model and fit_model_banded on the card
to their first E-step, recording the batch each passes to its DP. Then
it times gap_sdtw and banded_dtw on those batches (the median of --reps
calls, CUDA events after a warm-up), each call's peak memory above what
was allocated before it, and each launch alone with its SM cycles a step
(a step: the warp's anti-diagonal step of the sweep), at the wrapper's
warps a case and at each of --warps, and holds every output bitwise to
the plain version.

It needs a CUDA card and fails without one. The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile

import torch

from ..ops import train_dtw as td
from .timing import (REPO, banded_case_steps, gap_case_steps, load_smoke, profile_launch, same,
                     sm_clock_mhz, timed_call)


def iteration1_batches(work: str, device="cuda", n_dna=None, n_rna=None, smoke=None) -> dict:
    """{"gap": (rows, cols, gap_up, gap_left), "banded": (evs, lvls,
    bands, end_slack)}: the first batch fit_model and fit_model_banded
    pass to their DPs over phase 12's cases (chip_smoke.py's workloads of
    phases 4 and 7, its seeds; n_dna / n_rna cut the reads, for a small
    run)."""
    import contextlib
    import io

    from ..io.fasta import read_fasta
    from ..models import train_model as tm

    smoke = smoke or load_smoke()
    n_dna = n_dna or smoke.N12_DNA_READS
    n_rna = n_rna or smoke.N12_RNA_READS
    d4, d7 = os.path.join(work, "dna"), os.path.join(work, "rna")
    os.makedirs(d4)
    os.makedirs(d7)
    fa, bl, truth = smoke.make_workload(d4, smoke.N_BASES, smoke.N_READS, smoke.SEED)
    fa7, bl7, truth7 = smoke.make_rna_workload(d7, smoke.N7_TX, smoke.N7_READS, smoke.SEED + 7)
    dna_paf, rna_paf = os.path.join(work, "dna.paf"), os.path.join(work, "rna.paf")
    smoke.write_truth_paf(dna_paf, truth, {smoke.contig_of(truth): smoke.N_BASES},
                          [f"read{i:05d}" for i in range(n_dna)])
    smoke.write_truth_paf(rna_paf, truth7, {nm: len(sq) for nm, sq in read_fasta(fa7)},
                          [f"read{i:05d}" for i in range(n_rna)])
    dna_cases = tm.load_cases(bl, fa, dna_paf, rna=False, k=6)
    rna_cases = tm.load_cases_trimmed_rna(bl7, fa7, rna_paf, k=5)
    first = {}

    def recorded(key, fn):
        def call(*a):
            first.setdefault(key, a[:4])
            return fn(*a)
        return call

    fns = (td.gap_pairs, td.banded_pairs)
    td.gap_pairs, td.banded_pairs = recorded("gap", fns[0]), recorded("banded", fns[1])
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            tm.fit_model(dna_cases, k=6, iters=2, verbose=False, device=device)
            tm.fit_model_banded(rna_cases, k=5, iters=2, verbose=False, device=device)
    finally:
        td.gap_pairs, td.banded_pairs = fns
    return first


class Batches:
    """Phase 12's iteration-1 batches on the card, and their plain
    versions' outputs."""

    def __init__(self, first: dict, dev):
        rows, cols, self.gu, self.gl = first["gap"]
        self.x, self.n = td.pack(rows, dev)
        self.y, self.m = td.pack(cols, dev)
        evs, lvls, bands, self.slack = first["banded"]
        self.e, self.nb = td.pack(evs, dev)
        self.lv, self.mb = td.pack(lvls, dev)
        self.band = torch.tensor(bands, dtype=torch.int32, device=dev)
        self.want_gap = td.gap_sdtw_plain(self.x, self.y, self.n, self.m, self.gu, self.gl)
        self.want_banded = td.banded_dtw_plain(self.e, self.lv, self.nb, self.mb, self.band,
                                               self.slack)

    def gap(self):
        return td.gap_sdtw(self.x, self.y, self.n, self.m, self.gu, self.gl)

    def banded(self):
        return td.banded_dtw(self.e, self.lv, self.nb, self.mb, self.band, self.slack)

    def gap_profile(self, reps: int, warps=None) -> dict:
        """The gap launch alone at warps a case (the wrapper's pick if
        None), its outputs held to the plain version."""
        made = []

        def make(clocks):
            made.append(td._gap_args(self.x, self.y, self.n, self.m, self.gu, self.gl, clocks,
                                     warps))
            return made[0]

        prof = profile_launch(td._library("gap_dtw").sf_gap_dtw, make,
                              gap_case_steps(self.n, self.m, td.GAP_STRIPE), reps, "gap_sdtw")
        args, out, _ = made[0]
        return dict(prof, warps=args[9], bitwise_vs_plain=same(out, self.want_gap))

    def banded_profile(self, reps: int, warps=None) -> dict:
        """The banded launch alone at warps a case (the wrapper's pick if
        None), its outputs held to the plain version."""
        made = []

        def make(clocks):
            made.append(td._banded_args(self.e, self.lv, self.nb, self.mb, self.band, self.slack,
                                        0.5, 0.25, clocks, warps=warps))
            return made[0]

        prof = profile_launch(td._library("banded_dtw").sf_banded_dtw, make,
                              banded_case_steps(self.nb, self.mb, self.band, self.slack), reps,
                              "banded_dtw")
        args, out, _ = made[0]
        return dict(prof, warps=args[11], bitwise_vs_plain=same(out, self.want_banded))


def run(bt: Batches, reps: int, warps_list: list[int]) -> dict:
    """Each call through its wrapper (ms, peak MB) and its launch alone
    with its clocks, at the wrapper's warps a case and at each of
    warps_list, every output held to the plain versions."""
    ok = same(bt.gap(), bt.want_gap) and same(bt.banded(), bt.want_banded)
    gms, gmb = timed_call(bt.gap, reps)
    bms, bmb = timed_call(bt.banded, reps)
    res = {"gap_ms": gms, "gap_peak_mb": gmb, "banded_ms": bms, "banded_peak_mb": bmb,
           "gap": bt.gap_profile(reps), "banded": bt.banded_profile(reps)}
    for w in warps_list:
        res[f"gap_warps{w}"] = bt.gap_profile(reps, w)
        res[f"banded_warps{w}"] = bt.banded_profile(reps, w)
    res["bitwise_vs_plain"] = ok and all(v["bitwise_vs_plain"] for v in res.values()
                                         if isinstance(v, dict))
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--warps", default="", help="comma-separated warps a case (1 to 4) to time "
                                                "both kernels' launches at")
    args = ap.parse_args(argv)
    warps_list = [int(v) for v in args.warps.split(",") if v]
    if any(not 1 <= w <= 4 for w in warps_list):
        ap.error(f"--warps {args.warps}: the kernels run 1 to 4 warps a case")
    if not torch.cuda.is_available():
        raise SystemExit("bench_train_dtw: needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    clk = sm_clock_mhz()[1]
    print(f"card: {smi}; max SM clock {clk:.0f} MHz")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="bench_train_dtw-", dir=os.path.join(REPO, "build"))
    try:
        bt = Batches(iteration1_batches(work, "cuda"), dev)
        print(f"gap batch B={bt.x.shape[0]}, N={bt.x.shape[1]}, M={bt.y.shape[1]}, "
              f"{int((bt.n.long() * bt.m.long()).sum())} cells, gaps {bt.gu:.4f}/{bt.gl:.4f}; "
              f"banded batch B={bt.e.shape[0]}, N={bt.e.shape[1]}, M={bt.lv.shape[1]}, "
              f"end_slack {bt.slack}")
        out = {"card": smi, "sm_clock_mhz": clk, "run": run(bt, args.reps, warps_list)}
        if not out["run"]["bitwise_vs_plain"]:
            raise SystemExit("bench_train_dtw: the kernels differ from the plain versions")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
