#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sigfish_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one Hopper GPU
(compute capability 9.0), nvcc and g++. It builds the port's kernels from
the checkout's sources, then runs five phases, and fails (exit code 1,
no result line) if any of them fails:

  1. device   CUDA present with capability (9, 0); prints the card's
              name and power limit, torch's CUDA and nvcc's versions
  2. build    the wavefront kernel (nvcc, sm_90a) and the native host
              library (g++); prints the seconds each took and
              native_host: true|false (false = the exact numpy host
              fallbacks ran)
  3. kernels  the wavefront kernel bit for bit against its plain PyTorch
              version on the card (B=64, Q=256, the phase-4 reference):
              full-length reads, clipped reads, std=True; window_top5
              and topk_candidates on the card against CPU copies, with
              planted ties
  4. main     R9 DNA `dtw -p 50 -q 250` through run_dtw on device="cuda"
              (B=512, 8 threads) over a seeded random 29,903-base
              reference (the length of the nCoV-2019 reference), both
              strands, 2,304 synthetic reads in 5 batches, one in ten
              short enough to be clipped; the launch count must be > 0,
              the PAF of a 96-read subset byte-identical to a
              device="cpu" run, and at least 80% of the reads must map
              over the position they were drawn from
  5. times    the kernel's ms per launch at the phase-4 shape (median of
              5 after a warm-up, CUDA events), its Gcell/s and bound, and
              the plain version's ms on the card

The line before the last is one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# workload of phase 4
N_BASES = 29_903
N_READS = 2_304
BATCH = 512
THREADS = 8
W = 250                 # -q
PREFIX = 50             # -p
SUBSET = 96             # reads checked byte for byte against the CPU path
SEED = 2019

# H100 SXM peak rates: f32 outside the tensor cores, and HBM3
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# f32 ALU operations per DP cell: sub, abs, min(left, diag), select(reset),
# min(up, .), add, select(free start), and the emitted-lane select
OPS_PER_CELL = 8


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def make_workload(d: str, n_bases: int, n_reads: int, seed: int):
    """A one-contig FASTA and a BLOW5 of pore-model reads drawn from it.
    Returns (fasta, blow5, truth): truth maps read id -> (strand, start,
    end) in forward-strand base coordinates."""
    import numpy as np

    from sigfish_tpu_torch.io.blow5 import Slow5Record, Slow5Writer
    from sigfish_tpu_torch.models.genref import _seq_bytes, kmer_ranks, reverse_complement
    from sigfish_tpu_torch.models.pore_model import MODEL_ID_DNA_R9, load_builtin_model

    rng = np.random.default_rng(seed)
    model = load_builtin_model(MODEL_ID_DNA_R9)
    k = model.kmer_size
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, n_bases))
    rc = reverse_complement(seq)
    fa = os.path.join(d, "ref.fa")
    with open(fa, "w") as f:
        f.write(f">synth_{n_bases}\n")
        for o in range(0, n_bases, 80):
            f.write(seq[o : o + 80] + "\n")
    bl = os.path.join(d, "reads.blow5")
    truth = {}
    with Slow5Writer(bl, header_data=[{"experiment_type": "genomic_dna"}]) as w:
        for i in range(n_reads):
            # one read in ten is short: 50 + 100 events < prefix + query
            n_ev = 150 if i % 10 == 9 else 400
            strand = "+" if rng.random() < 0.5 else "-"
            s = int(rng.integers(0, n_bases - n_ev - k))
            sub = (seq if strand == "+" else rc)[s : s + n_ev + k - 1]
            levels = model.level_mean[kmer_ranks(_seq_bytes(sub), k, warn_non_acgt=False)]
            pa = np.repeat(levels, rng.integers(9, 15, size=levels.size)).astype(np.float64)
            pa += rng.normal(0.0, 1.2, pa.size)
            raw = np.clip(np.rint(pa * 8192.0 / 1400.0 - 10.0), -32000, 32000)
            rid = f"read{i:05d}"
            w.write_record(Slow5Record(
                read_id=rid, read_group=0, digitisation=8192.0, offset=10.0,
                range=1400.0, sampling_rate=4000.0, raw_signal=raw.astype(np.int16),
            ))
            lo, hi = s, s + n_ev + k - 1
            truth[rid] = (strand, lo, hi) if strand == "+" else (strand, n_bases - hi, n_bases - lo)
    return fa, bl, truth


def subset_blow5(bl: str, out: str, keep) -> None:
    """Copy the records whose read id is in `keep` into a new BLOW5."""
    from sigfish_tpu_torch.io.blow5 import Slow5File, Slow5Writer

    with Slow5File(bl) as src, Slow5Writer(out, header_data=[{"experiment_type": "genomic_dna"}]) as dst:
        for rec in src:
            if rec.read_id in keep:
                dst.write_record(rec)


def run_port(fa: str, bl: str, device: str, state=None, profile: bool = False):
    """run_dtw over a whole file; returns (PAF text, Core, seconds).
    profile=True runs the host stages one by one with their timers
    (--profile-cpu) and drains each batch before the next."""
    from sigfish_tpu_torch.runtime.pipeline import Core, Options, run_dtw

    opt = Options(batch_size=BATCH, num_thread=THREADS, prefix_size=PREFIX,
                  query_size=W, device=device, profile=profile)
    core = Core(fa, bl, opt, state=state)
    out = io.StringIO()
    t0 = time.time()
    run_dtw(core, out)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    dt = time.time() - t0
    core.close()
    return out.getvalue(), core, dt


def overlap_share(paf: str, truth: dict) -> float:
    """Share of reads whose PAF target interval, on the right strand,
    overlaps the interval the read was drawn from."""
    hit = 0
    for line in paf.splitlines():
        f = line.split("\t")
        strand, lo, hi = truth[f[0]]
        if f[4] == strand and int(f[7]) < hi and int(f[8]) > lo:
            hit += 1
    return hit / len(truth)


def bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32).cpu(), b.contiguous().view(torch.int32).cpu()
    )


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the GPU")
    if not os.path.isdir(os.path.join(REPO, "sigfish_tpu_torch")):
        fail(f"no sigfish_tpu_torch package beside {__file__}: run it from a checkout")
    sys.path.insert(0, REPO)

    import numpy as np

    from sigfish_tpu_torch.kernels import build as kbuild
    from sigfish_tpu_torch.ops import layout
    from sigfish_tpu_torch.ops import sdtw_wavefront as wfm
    from sigfish_tpu_torch.ops.candidates_dev import topk_candidates, window_top5

    # ---------------------------------------------------------------- 1
    phase("1 device")
    dev = torch.device("cuda")
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    if cap != (9, 0):
        fail(f"{name} has compute capability {cap}; the kernels are built for sm_90a")
    smi = smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}")
    r = subprocess.run([kbuild.nvcc_path(), "--version"], capture_output=True, text=True, timeout=60)
    print("nvcc: " + (r.stdout.strip().splitlines() or ["?"])[-1])

    # ---------------------------------------------------------------- 2
    phase("2 build")
    t0 = time.time()
    reports = kbuild.build_all()
    print(f"kernels built in {time.time() - t0:.2f} s")
    for kname, rep in reports.items():
        for ln in rep.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {kname}: {ln.strip()}")
    t0 = time.time()
    from sigfish_tpu_torch import native

    native_ok = native.available()  # builds it (g++) on first use
    print(f"native host library built and loaded in {time.time() - t0:.2f} s")
    print(f"native_host: {'true' if native_ok else 'false'}")

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.time()
        fa, bl, truth = make_workload(work, N_BASES, N_READS, SEED)
        print(f"workload: {N_READS} reads over {N_BASES} bases, made in {time.time() - t0:.2f} s")

        from sigfish_tpu_torch.runtime.pipeline import Core, Options

        probe = Core(fa, bl, Options(query_size=W, prefix_size=PREFIX, num_thread=1, device="cuda"))
        state, pad_q = probe.state, probe.pad_q
        probe.close()
        R = state.ref_cat.shape[0]
        ypad_h, rspad_h, D = layout.prepare_wavefront_inputs(state.ref_cat, state.reset, pad_q)
        ypad = torch.from_numpy(ypad_h).to(dev)
        rspad = torch.from_numpy(rspad_h).to(dev)
        u_h, valid_h = layout.build_column_maps(state.offsets, R, track_sizes=state.track_sizes)
        print(f"reference: {len(state.track_sizes)} tracks, R={R} columns, D={D} diagonals, Q={pad_q}")

        # ------------------------------------------------------------ 3
        phase("3 kernels against their plain versions")
        rng = np.random.default_rng(SEED + 1)
        B3 = 64
        qlens = np.full(B3, W, np.int32)
        qlens[::4] = rng.integers(25, W, size=qlens[::4].size)
        qlist = [rng.standard_normal(int(n)).astype(np.float32) for n in qlens]
        qb, qlens, _ = layout.make_query_batch(qlist, pad_q=pad_q)
        qb_k, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
        max_err = 0.0
        full = [rng.standard_normal(W).astype(np.float32) for _ in range(B3)]
        for label, q_h, fs_h, std in (
            ("full-length", layout.make_query_batch(full, pad_q=pad_q)[0], None, False),
            ("clipped", qb_k, fs, False),
            ("std", qb_k, fs, True),
        ):
            q = torch.from_numpy(q_h).to(dev)
            sl = None if fs_h is None else torch.from_numpy(fs_h).to(dev)
            got = wfm.sdtw_wavefront(q, ypad, rspad, W - 1, start_lanes=sl, std=std)
            torch.cuda.synchronize()
            t0 = time.time()
            want = wfm.wavefront_plain(q, ypad, rspad, W - 1, sl, std)
            torch.cuda.synchronize()
            ok = bits_equal(got, want)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            print(f"wavefront {label}: B={q.shape[0]} Q={q.shape[1]} D={D} bitwise_equal={ok} "
                  f"max_abs_err={err} (plain {time.time() - t0:.1f} s)")
            if not ok:
                fail(f"wavefront kernel differs from its plain version ({label})")
            if label == "clipped":
                scores = got

        # the candidate reduction on the card against CPU copies, on the
        # kernel's scores and on small-integer scores full of ties
        valid_d = torch.from_numpy(valid_h).to(dev)
        u_d = torch.from_numpy(u_h).to(dev)
        qlens_d = torch.from_numpy(qlens).to(dev)
        ties = torch.from_numpy(rng.integers(0, 6, size=(B3, D)).astype(np.float32)).to(dev)
        ties[0] = 3.0
        for label, sc in (("kernel scores", scores), ("planted ties", ties)):
            a = window_top5(sc, valid_d, R, W, pack=True)
            b = window_top5(sc.cpu(), valid_d.cpu(), R, W, pack=True)
            lr = sc[:, W - 1 : W - 1 + R]
            c = topk_candidates(lr, qlens_d, u_d, valid_d, R, reindex=False, pack=True)
            e = topk_candidates(lr.cpu(), qlens_d.cpu(), u_d.cpu(), valid_d.cpu(), R,
                                reindex=False, pack=True)
            ok = bits_equal(a, b) and bits_equal(c, e)
            print(f"window_top5 / topk_candidates on {label}: bitwise_equal={ok}")
            if not ok:
                fail(f"candidate reduction on the card differs from the CPU ({label})")
        del scores, ties

        # ------------------------------------------------------------ 4
        phase("4 main path at full width")
        wfm.sdtw_wavefront.launches = 0
        paf, core, dt = run_port(fa, bl, "cuda", state=state)
        launches = wfm.sdtw_wavefront.launches
        n_lines = len(paf.splitlines())
        print(f"run_dtw on cuda: {core.total_reads} reads, {n_lines} PAF lines, "
              f"{dt:.3f} s, {core.total_reads / dt:.1f} reads/s end to end; "
              f"wavefront launches: {launches}")
        if launches <= 0:
            fail("the main path launched no wavefront kernel")
        if core.total_reads != N_READS:
            fail(f"{core.total_reads} reads processed, want {N_READS}")
        share = overlap_share(paf, truth)
        print(f"reads mapped over their origin: {share:.4f}")
        if share < 0.8:
            fail(f"only {share:.4f} of the reads map over the position they were drawn from")

        ppaf, pcore, pdt = run_port(fa, bl, "cuda", state=state, profile=True)
        print(f"stages, --profile-cpu run ({pdt:.3f} s, unoverlapped): load "
              f"{pcore.load_db_time:.3f} s, parse {pcore.parse_time:.3f} s, events "
              f"{pcore.event_time:.3f} s, normalise {pcore.normalise_time:.3f} s, "
              f"device + backtrack + PAF {pcore.dtw_time:.3f} s")
        if ppaf != paf:
            fail("the --profile-cpu run's PAF differs from the overlapped run's")

        by_id = {ln.split("\t")[0]: ln for ln in paf.splitlines()}
        keep = [f"read{i:05d}" for i in range(SUBSET)]
        n_clip = sum(1 for i in range(SUBSET) if i % 10 == 9)
        sub_bl = os.path.join(work, "subset.blow5")
        subset_blow5(bl, sub_bl, set(keep))
        cpu_paf, _, cpu_dt = run_port(fa, sub_bl, "cpu", state=state)
        want = "".join(by_id[r] + "\n" for r in keep if r in by_id)
        ok = cpu_paf == want
        print(f"PAF of {SUBSET} reads ({n_clip} clipped) on cpu vs cuda: "
              f"byte_identical={ok} (cpu {cpu_dt:.1f} s)")
        if not ok:
            fail("the cuda path's PAF differs from the cpu path's")

        # ------------------------------------------------------------ 5
        phase("5 times")
        rng = np.random.default_rng(SEED + 2)
        B5 = BATCH
        q = torch.from_numpy(rng.standard_normal((B5, pad_q)).astype(np.float32)).to(dev)
        before = wfm.sdtw_wavefront.launches
        wfm.sdtw_wavefront(q, ypad, rspad, W - 1)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            wfm.sdtw_wavefront(q, ypad, rspad, W - 1)
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        ms = statistics.median(times)
        wfm.sdtw_wavefront.launches = before  # timing launches are not the main path's
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        wfm.wavefront_plain(q, ypad, rspad, W - 1)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1)
        cells = B5 * pad_q * D
        ops = OPS_PER_CELL * cells
        nbytes = 4 * (B5 * pad_q + 2 * D + B5 * D)
        bound_ms = max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3
        bound_by = "operations" if ops / PEAK_F32_OPS >= nbytes / PEAK_BYTES else "bytes"
        print(f"kernel time in the main path: about {launches * ms / 1e3:.3f} s of "
              f"run_dtw's {dt:.3f} s ({launches} launches x {ms:.3f} ms)")
        print(f"wavefront B={B5} Q={pad_q} D={D}: {ms:.3f} ms per launch (median of {times}), "
              f"{cells / ms / 1e6:.1f} Gcell/s, bound {bound_ms:.3f} ms by {bound_by} "
              f"({OPS_PER_CELL} f32 ops/cell at {PEAK_F32_OPS / 1e12:.0f} TFLOP/s), "
              f"plain version {plain_ms:.1f} ms; card: {smi}")

        result = {"kernels": [{
            "name": "sdtw_wavefront",
            "route": "cuda",
            "source": "sigfish_tpu_torch/csrc/wavefront.cu",
            "replaces": "sigfish_tpu/ops/sdtw_pallas.py:174",
            "launches": launches,
            "max_abs_err": max_err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        }]}
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
