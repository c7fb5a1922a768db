#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (sigfish_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one Hopper GPU
(compute capability 9.0), nvcc and g++. It builds the port's kernels from
the checkout's sources, then runs thirteen phases, and fails (exit code 1,
no result line) if any of them fails:

  1. device   CUDA present with capability (9, 0); prints the card's
              name and power limit, torch's CUDA and nvcc's versions,
              and the f32 issue rate every bound is computed at (SMs x
              128 instructions per clock x the maximum SM clock)
  2. build    the wavefront, ALU-probe, events, polyA, gap-DTW,
              banded-DTW and scan kernels (nvcc,
              sm_90a, one process each, started together; ptxas'
              registers and spills of every Q=512 instance, a summary of
              the rest) and
              the native host library (g++); prints the seconds each took
              and native_host: true|false (false = the exact numpy host
              fallbacks ran)
  3. kernels  the wavefront kernel bit for bit against its plain PyTorch
              version on the card, every warps-per-read instance (1, 2,
              4, 8) against one plain run (Q=256, the phase-4
              reference): full-length reads, clipped reads, std=True at
              B=64, and clipped reads at B=16; the same for
              its carry mode chained over three uneven segments, every
              warps instance and one chain mixing warp counts (scores,
              and the outgoing state under carry_state_mask, against the
              plain carry chain, and the chained scores against the
              one-shot launch); the chunked
              top-5 on the card against window_top5 of the one-shot
              kernel; the chunked route's clip fold (a carry chain with
              start lanes over four segments, clipped reads of qlen 25,
              97 and W-1, ties planted across segment boundaries by flat
              reference stretches) against topk_candidates of the
              one-shot kernel's scores on the card; window_top5 and
              topk_candidates on the card against CPU copies, with
              planted ties; at Q=512 over the first 24,576 diagonals of
              phase 7's reference, B=64: every one-shot warps instance
              with full-length rows, and with a third of the rows clipped
              (qlen 25 up to W-1), and the carry mode chained over three
              segments with those start lanes (every warps instance and a
              mixed chain, the state under carry_state_mask)
  4. main     R9 DNA `dtw -p 50 -q 250` through run_dtw on device="cuda"
              (B=512, 8 threads) over a seeded random 29,903-base
              reference (the length of the nCoV-2019 reference), both
              strands, 2,304 synthetic reads in 5 batches, one in ten
              short enough to be clipped; the launch count must be > 0,
              the PAF of a 96-read subset byte-identical to a
              device="cpu" run, and at least 80% of the reads must map
              over the position they were drawn from
  5. times    the ALU probe through its entry point
              (sigfish_tpu_torch.scripts.bench_alu_peak): Gop/s per mode,
              each mode bit for bit against its plain version; the
              wavefront kernel's ms per launch at the phase-4 shape and
              the carry kernel's per segment launch (B=512, Q=256,
              Ds=32,000), each with its Gcell/s, its bound at the f32
              issue rate and against the probe's max(mix, mix2)
              in wavefront steps, and the plain version's ms on the
              card; the outputs of those timed plain runs hold the
              kernels bit for bit at the main path's shapes: the one-shot
              scores (every warps instance), and the carry kernel's
              scores and outgoing state over two chained segments
              (fresh, then carried state) at the instance carry_warps
              picks, with no start lanes and with start lanes and one
              row in ten clipped as in phase 6 (the state there under
              carry_state_mask); the carry kernel's table of ms per segment launch
              for each warps instance at B = 16, 128, 512 and 1,024
              (sigfish_tpu_torch.scripts.bench_carry) and at B=512 with
              start lanes 0 (the instance without FS0), B=512's SM cycles
              per diagonal beside the probe's ceiling, and its inner
              loop's SASS instructions per diagonal where cuobjdump
              exists; then a table of the one-shot
              kernel's ms per launch for each warps instance at B = 16,
              64, 128, 256, 512 and 1,024 over the phase-4 reference, the
              instance ops/sdtw_wavefront.wavefront_warps picks marked
              with *, and B=16's SM cycles per diagonal; the same table at
              Q=512 over phase 7's reference (B = 16 to 512) and B=512's
              time and bound there, where the timed plain version's
              output holds every warps instance bit for bit. Every bound
              is at the f32 issue rate, and each kernel's share of it is
              printed
  6. chunked  the chunked reference at full width: a seeded random
              4,641,652-base reference (the length of E. coli K-12
              MG1655), both strands (about 9.28M columns), 1,536 reads in
              3 batches, one in ten clipped, through the automatic
              chunked route (ref_chunk=0); the carry launch count must be
              > 0, the main fold must have launched the carry instance
              carry_warps picks at B=512, every launch with start lanes
              (the clipped rows ride the batch's chain), the one-shot
              kernel never, the clip fold must have served each batch
              once, the PAF of a 128-read subset byte-identical to the
              one-shot route (ref_chunk=-1) on the card, and at least 80%
              of the reads must map over their origin. Prints reads/s,
              the device seconds of the chunked chains (CUDA events, in
              a --profile-cpu run whose PAF must be the same), the
              clip fold's device and host ms per segment beside the
              carry launch's, and the peak device memory of the runs
              beside what the one-shot (512, D) score buffer alone
              would take. Before
              that, the phase-4 subset through a forced ref_chunk of
              4,000 diagonals on the card is held byte for byte to the
              same on the CPU.
  7. RNA      the default direct-RNA run, `dtw --rna -q 500 -p -1`, through
              run_dtw on device="cuda" (B=512, 8 threads): 160 seeded
              random transcripts of 600-7,000 bases (the size of sigfish's
              sequin transcriptome test; forward 3'-end tracks of min(750,
              L-4) events, about 160k columns, Q=512), 1,536 reads in 3
              batches, each an adaptor and a polyA stretch before the
              transcript's 3' end, one in ten clipped (under 500 events
              past the polyA), one in twenty without adaptor and polyA
              (prefix fail); the one-shot launch count must be > 0, the
              clip pass must have run, prefix fail > 0, at least 75% of the
              reads must map over their origin, and the PAF of a 64-read
              subset must be byte-identical to a device="cpu" run and to a
              forced ref_chunk of 32,000 diagonals on the card. Prints
              reads/s and the stage and device seconds of a --profile-cpu
              run.
  8. surface  the rest of the dtw surface, each run through run_dtw on
              device="cuda" with its launch counts, reads/s and counters
              printed: over phase 4's workload --sam (as many records as
              phase 4's PAF lines; the header and a 96-read subset
              byte-identical to device="cpu") and --from-end (the same
              subset check), and eval of phase 4's PAF against a truth PAF
              of the reads' origins (at least 80% correct); R10 DNA, 1,536
              reads from the R10 9-mer table over a phase-4-size
              reference with the kit sqk-lsk114 and no --pore (the log
              must say R10 was detected, at least 80% mapped over their
              origin, a 64-read subset byte-identical to the CPU); over
              phase 7's transcripts and reads, --dtw-std (every one-shot
              launch the std instance, at least 75% mapped, the whole
              PAF byte-identical to a forced ref_chunk of 32,000 on the
              card, which launches the std carry instance; the std
              instance's ms per B=512, Q=512 launch over the whole
              reference and its bound, every warps instance and the timed
              launch bit for bit against one plain run, whose ms is
              printed too; the std carry instance's ms per 32,000-diagonal
              segment at each warps instance, each timed launch held to
              one plain carry launch), --full-ref (its B=512 launch over
              the whole tracks, about 659k diagonals, timed and held bit
              for bit to one plain run; at least 75% mapped) and --invert
              -p 0; RNA004,
              1,536 reads from the RNA004 9-mer table with the kit
              sqk-rna004 and -p -1 (detected, at least 75% mapped); then
              each RNA flag (--dtw-std, also through a forced ref_chunk,
              --full-ref, --invert -p 0, --from-end -p 0, RNA004) over a
              small reference (20 transcripts, 64 reads, Q=512) on the
              card and on the CPU, byte for byte; and the std instances
              at B=512, Q=512 over it: every one-shot warps instance
              against the plain version, and a three-segment carry
              chain (every warps instance and a mixed one) against it and
              the one-shot launch.
  9. host     --host-stages device: the events kernel (csrc/events.cu)
     stages   bit for bit against its plain version, whole and each of its
              four stages (prefix, t-stat, detector, gather) alone on the
              plain version's inputs, on a 64-read fuzz batch (S=8,192:
              stepwise, noise, near-flat, short and polyA-shaped reads and
              one whose events overflow the cap) and on the ragged-edge
              batch (B=37 and its first 32 rows) with DNA and RNA
              windows, and the polyA kernel (csrc/polya.cu) with R9
              and RNA004 parameters on the fuzz and ragged batches; every
              read of phases 4 and 7 through
              the pipeline's buckets, its event table bit for bit against
              the host eventizer (reads whose polyA end differs from the
              host scan's are printed); each kernel's ms a launch at the
              largest bucket of phase 4 (events) and phase 7 (both), held
              bit for bit (events stage by stage) to one plain run, beside
              its bound and chain floor, the events stages' ms alone and
              the prefix and detector cycles a step, and ptxas' report of
              every entry (registers, shared memory, spills);
              run_dtw with --host-stages device on the card over
              phase 4's, phase 7's, phase 8's RNA004 and phase 6's reads,
              each whole PAF byte-identical to the host mode's, with the
              launch counts (> 0), the reads sent to the host path, reads/s
              beside host mode's, and the main thread's wait for the side
              stream's results (split into the wait for the kernels and
              assemble_events' own time) beside their device time (phase
              6: the overlap with the chunked sDTW); and phase 7's
              --profile-cpu stage split in device mode, with the same
              wait split.
  10. mesh    --mesh over the card listed once per shard (mesh_devices
              ["cuda:0"] * DP*TP, a stream per shard): tracks mode over
              phase 4's workload at 2x1 and phase 7's at 2x2 (host
              stages on the host and on the card), and ring mode over
              phase 6's E. coli reference (2 tracks, fewer than TP) at
              1x4 for its first 512 reads, clipped ones among them; each
              whole PAF byte-identical to that phase's single-device
              PAF. Fails unless the one-shot launches are batches x DP x
              TP in tracks mode, the ring's carry launches batches x 32
              microbatches x 4 x ring_n_sub (> 1, the auto rule) with the
              clipped sub-batch on the chunked route, Core.routes shows
              the mode and no plain sweep ran; prints reads/s, each
              run's peak memory, the mesh route's device seconds
              (--profile-cpu) and ms per shard launch. Each timed shard
              launch is held bit for bit to the plain version on the
              same inputs: a one-shot shard of each tracks run (shard
              0's tracks, one row in ten from its start lane), and a
              ring hop at B=16 (shard 0's last sub-chunk from a fresh
              state, then shard 1's first from the state handed on).
  11. hosts   the multi-host run, `python -m sigfish_tpu_torch.cli dtw`
              processes on the card, each with a time limit: a --hosts 2
              cluster (--host-id, --coordinator localhost:PORT, a
              TCPStore served by host 0) over phase 4's workload, host
              0's -o byte-identical to phase 4's PAF, the peer's -o never
              created and the (all 2 hosts) counters phase 4's; the same
              over phase 7's with --host-stages device (byte-identical to
              phase 7's PAF; the wavefront, events and polyA kernels
              launched in each process, read from its -v 5 report);
              --shard 0/2 and 1/2 over phase 4's side by side, each
              stripe the phase-4 lines of its records (index = I mod 2)
              in file order; and --trace DIR over phase 4's run in this
              process (its PAF phase 4's, the Chrome trace's events of
              the wavefront kernel, by its __global__ name, counted
              beside the launch counter, the kernels' busy seconds beside
              the trace's span). Prints each run's wall seconds, reads/s
              and each host's Data processing time.
  12. train   the pore-model trainer (sigfish_tpu_torch.models.
              train_model) on the card: fit_model learns the R9 DNA
              6-mer table from phase 4's first 256 reads (4 EM
              iterations, the verbose diagnostic on), fit_model_banded
              (3) and finetune_inference_matched (2) the R9 RNA 5-mer
              table from phase 7's first 512 reads, each with a truth
              PAF of the reads' origins (write_truth_paf). Prints each
              iteration's E-step device seconds, host seconds and kernel
              launches, and each table's Pearson correlation with the
              shipped table the reads were drawn from (not gated); holds
              the gap and banded kernels bit for bit to their plain
              versions on iteration 1's cases, times them (one launch a
              call: each call's ms, SM cycles a step of the largest
              case, its chain floor and its peak device memory, with
              the card's name and power limit), and holds the
              card's tables over the first 16 reads of each (2
              iterations each) bit for bit to the port's CPU run.
  13. engines the engine choice (--engine pallas|scan|native, --accel):
              the scan kernel (csrc/scan.cu) bit for bit against its
              plain version on B=64 (one read in three clipped, one of
              qlen 0), one-shot at Q=256 over 20,000 of phase 4's columns
              and at Q=512 over phase 7's first 24,576, std at Q=512, and
              a carry chain of three uneven segments against the one-shot
              launch; its launch timed at B=512 over phase 4's whole
              reference (Q=256) and phase 7's (Q=512), each held to one
              plain run (whose ms is printed), beside its bound (the
              function's 8 operations a cell, and the 10 the kernel
              issues); phase 4's and phase 7's workloads on the scan
              engine (the launches counted, no wavefront, the lines
              differing from the default engine's PAF printed, the
              mapped share gated, the first 128 and 64 reads
              byte-identical to the port's CPU scan); --engine native
              over phase 4's reads byte-identical to the default engine
              with no launch;
              --accel yes the default's
              PAF, --accel no the scan's; and the scan on --mesh 2x1
              (tracks) and 1x4 (ring) over the card listed once per
              shard, each byte-identical to the single-device scan.
              Prints each engine's reads/s.

The line before the last is one JSON object with the kernels' numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
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

# workload of phase 6: E. coli K-12 MG1655 (NCBI NC_000913.3) length
ECOLI_BASES = 4_641_652
N6_READS = 1_536
SUBSET6 = 128           # reads checked byte for byte against the one-shot route
CPU_REF_CHUNK = 4_000   # forced segment of the card-vs-CPU chunked check

# workload of phase 7: direct RNA `--rna -q 500 -p -1`, the size of
# sigfish's sequin transcriptome test (160 contigs)
RNA_OPT = dict(rna=True, query_size=500, prefix_size=-1)
N7_TX = 160
N7_READS = 1_536
TX_LEN = (600, 7_000)   # transcript lengths: both sides of gen_ref's min(750, L-4)
SUBSET7 = 64            # reads checked byte for byte against the CPU path
SUBSET13 = 128          # phase 13: phase 4's reads on the scan engine, card vs CPU
CUT3_DIAGS = 24_576     # phase 3's Q=512 checks: the RNA reference's first diagonals

# phase 10: --mesh over the card listed once per shard (a stream each)
MESH_DNA = "2x1"        # tracks mode over phase 4's workload
MESH_RNA = "2x2"        # tracks mode over phase 7's 160 tracks
MESH_RING = "1x4"       # ring mode over phase 6's E. coli: 2 tracks < TP
N10_READS = 512         # the ring's one batch: phase 6's first reads, clipped ones among them

# phase 11: the multi-host run, `python -m sigfish_tpu_torch.cli dtw`
# processes on the card over phase 4's and phase 7's workloads
HOSTS = 2
HOST_TIMEOUT_S = 300    # each phase-11 command's limit, its processes together

# phase 12: the pore-model trainer over phase 4's and phase 7's reads, at
# full width (k, features, gaps and band unchanged); the iterations cut
# from fit_model's 20, fit_model_banded's 9 and the finetune's 4
N12_DNA_READS = 256
N12_RNA_READS = 512
ITERS12_DNA = 4
ITERS12_RNA = 3
ITERS12_FINETUNE = 2
N12_CPU_READS = 16      # the card's tables held to the CPU run's over these
ITERS12_CPU = 2
# operations a cell of the JAX functions: the gap DP's |x - y|, cumsum
# add, prev + gl, min, two subtractions, prefix min and two adds; the
# banded DP's |x - y|, up and left adds, two compares and the add
GAP_OPS_PER_CELL = 10
BANDED_OPS_PER_CELL = 7
# the kernels' chains, in dependent f32 operations a step of the largest
# case (LAT_F32 cycles each; the shuffles' latency not counted): the gap
# sweep's lane runs its R rows' s additions in order, then the last row's
# t, h and col; a banded cell adds up + gap_up, takes two compare-selects
# and adds |ev - lvl|
GAP_CHAIN_EXTRA = 3
BANDED_CHAIN_OPS = 4

# workload of phase 8: the rest of the dtw surface
N8_READS = 1_536        # R10 DNA reads over a phase-4-size reference
SUBSET8 = 64            # R10 reads checked byte for byte against the CPU path
N8_SMALL_TX = 20        # the small RNA reference of the card-vs-CPU checks
N8_SMALL_READS = 64
SMALL_TX_LEN = (600, 2_000)

# phase 9: the host stages' kernels, a thread a read. Operations a sample
# as counted in their loops, each arithmetic instruction one operation (a
# division or square root too, so the bounds err low): csrc/events.cu's
# prefix pass 3 f32 and 4 f64, each of its two t-stats 6 f32 and 22 f64,
# each of its two detectors ~10 f32 or integer; csrc/polya.cu ~10 in each
# of its three passes over t, 4 in the adaptor's sum, ~15 in the jnn_core
# pass. f64 instructions issue at 64 per SM and clock, half the f32 rate.
EVENTS_F32_OPS = 3 + 2 * 6 + 2 * 10
EVENTS_F64_OPS = 4 + 2 * 22
POLYA_OPS = 3 * 10 + 4 + 15
F64_PER_F32_ISSUE = 0.5
# the dependent chains' latencies the floors assume, in SM cycles: an f64
# add (the prefix sums' chain), a dependent f32 add or compare-and-select
# (the running mean, the state machines' carried state)
LAT_F64_ADD = 8
LAT_F32 = 4

# the events kernel's stage times in the kernels line (a stage alone)
EVENT_STAGE_KEYS = ("ms_prefix", "ms_tstat", "ms_detector", "ms_gather",
                    "cycles_per_step_prefix", "cycles_per_step_detector")

# ALU probe iterations per launch (the bench's default)
PROBE_ITERS = 16384

# the sweeps' f32 operations (min, add, select; no FMA, built with
# -fmad=false) issue at most 128 per SM per clock: their ceiling is that
# issue rate at the SM clock nvidia-smi reads, not the data sheet's f32
# rate, which counts an FMA as two operations. HBM3's rate for bytes.
F32_ISSUE_PER_SM_CLK = 128
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T_START = time.time()


def phase(name: str) -> None:
    print(f"== {name} (at {time.time() - T_START:.1f} s)", flush=True)


def smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


DNA_HEADER = [{"experiment_type": "genomic_dna"}]
R10_HEADER = [{"experiment_type": "genomic_dna", "sequencing_kit": "sqk-lsk114"}]


def make_workload(d: str, n_bases: int, n_reads: int, seed: int, r10: bool = False,
                  header=None):
    """A one-contig FASTA and a BLOW5 of pore-model reads drawn from it:
    R9 DNA, or with r10=True R10 DNA from the R10 9-mer table (header:
    its header_data, R9's or R10's kit by default). Returns (fasta,
    blow5, truth): truth maps read id -> (contig, strand, start, end) in
    forward-strand base coordinates."""
    import numpy as np

    from sigfish_tpu_torch.io.blow5 import Slow5Record, Slow5Writer
    from sigfish_tpu_torch.models.genref import _seq_bytes, kmer_ranks, reverse_complement
    from sigfish_tpu_torch.models.pore_model import (
        MODEL_ID_DNA_R9,
        MODEL_ID_DNA_R10,
        load_builtin_model,
    )

    rng = np.random.default_rng(seed)
    model = load_builtin_model(MODEL_ID_DNA_R10 if r10 else MODEL_ID_DNA_R9)
    if header is None:
        header = R10_HEADER if r10 else DNA_HEADER
    k = model.kmer_size
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, n_bases))
    rc = reverse_complement(seq)
    fa = os.path.join(d, "ref.fa")
    contig = f"synth_{n_bases}"
    with open(fa, "w") as f:
        f.write(f">{contig}\n")
        for o in range(0, n_bases, 80):
            f.write(seq[o : o + 80] + "\n")
    bl = os.path.join(d, "reads.blow5")
    truth = {}
    with Slow5Writer(bl, header_data=header) as w:
        for i in range(n_reads):
            # one read in ten is short enough to be clipped: the detector
            # finds about 2.1 events per pore-model level, so 120 levels
            # give 240-275 events, fewer than prefix + query = 300
            n_ev = 120 if i % 10 == 9 else 400
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
            truth[rid] = ((contig, strand, lo, hi) if strand == "+"
                          else (contig, strand, n_bases - hi, n_bases - lo))
    return fa, bl, truth


RNA_HEADER = [{"experiment_type": "rna", "sequencing_kit": "sqk-rna002"}]
RNA004_HEADER = [{"experiment_type": "rna", "sequencing_kit": "sqk-rna004"}]


def make_rna_workload(d: str, n_tx: int, n_reads: int, seed: int, tx_len=TX_LEN,
                      walks=(560, 240), rna004: bool = False, header=None,
                      adaptor=(9_000, 14_000)):
    """A FASTA of n_tx seeded random transcripts and a BLOW5 (header
    experiment_type rna) of direct-RNA reads. Each read is an adaptor
    stretch (20 pA, by default 9,000-14,000 samples: `adaptor` is the
    half-open range), a polyA stretch (62 pA,
    1,000-3,000 samples: inside sigfish's band of the adaptor mean + 30
    +-20 pA, above the adaptor finder's threshold, below every R9 and
    RNA004 RNA level), then a transcript's 3' end walked towards 5'
    through the R9 RNA pore model (with rna004=True the RNA004 9-mer
    table, and RNA004's kit in the header): walks[0] levels, by default
    560, about 760 events past the polyA. One read in ten (i % 10 == 9)
    walks walks[1] levels, by default 240, about 320 events, fewer than
    -q 500, so it is clipped; one in twenty (i % 20 == 4) has no adaptor
    and no polyA, so its query start falls back to event 50 (prefix
    fail). header: its header_data, R9's or RNA004's by default. The
    FASTA depends on (n_tx, seed, tx_len) only. Returns (fasta, blow5,
    truth): truth maps read id -> (contig, "+", start, end), the walk's
    bases."""
    import numpy as np

    from sigfish_tpu_torch.io.blow5 import Slow5Record, Slow5Writer
    from sigfish_tpu_torch.models.genref import _seq_bytes, kmer_ranks
    from sigfish_tpu_torch.models.pore_model import (
        MODEL_ID_RNA_R9,
        MODEL_ID_RNA_RNA004,
        load_builtin_model,
    )

    rng = np.random.default_rng(seed)
    model = load_builtin_model(MODEL_ID_RNA_RNA004 if rna004 else MODEL_ID_RNA_R9)
    if header is None:
        header = RNA004_HEADER if rna004 else RNA_HEADER
    k = model.kmer_size
    fa = os.path.join(d, "tx.fa")
    seqs = []
    with open(fa, "w") as f:
        for j in range(n_tx):
            seq = "".join("ACGT"[b] for b in rng.integers(0, 4, int(rng.integers(*tx_len))))
            seqs.append((f"tx{j:03d}", seq))
            f.write(f">tx{j:03d}\n")
            for o in range(0, len(seq), 80):
                f.write(seq[o : o + 80] + "\n")
    bl = os.path.join(d, "reads.blow5")
    truth = {}
    with Slow5Writer(bl, header_data=header) as w:
        for i in range(n_reads):
            name, seq = seqs[int(rng.integers(n_tx))]
            n_kmer = len(seq) + 1 - k
            walk = min(n_kmer, walks[1] if i % 10 == 9 else walks[0])
            levels = model.level_mean[kmer_ranks(_seq_bytes(seq[n_kmer - walk :]), k,
                                                 warn_non_acgt=False)][::-1]
            n_ad, n_pa = (0, 0) if i % 20 == 4 else (int(rng.integers(*adaptor)),
                                                     int(rng.integers(1_000, 3_000)))
            tx = np.repeat(levels, rng.integers(20, 45, size=levels.size)).astype(np.float64)
            pa = np.concatenate([rng.normal(20.0, 2.0, n_ad), rng.normal(62.0, 2.0, n_pa),
                                 tx + rng.normal(0.0, 1.5, tx.size)])
            raw = np.clip(np.rint(pa * 8192.0 / 1400.0 - 10.0), -32000, 32000)
            rid = f"read{i:05d}"
            w.write_record(Slow5Record(
                read_id=rid, read_group=0, digitisation=8192.0, offset=10.0,
                range=1400.0, sampling_rate=3012.0, raw_signal=raw.astype(np.int16),
            ))
            truth[rid] = (name, "+", n_kmer - walk, len(seq))
    return fa, bl, truth


def fuzz_reads(rng, n: int, rna: bool) -> list:
    """The eventizer's fuzz mix (that of sigfish_tpu's device-eventizer
    tests): i16 signals, half stepwise model-like dwell signals, a quarter
    pure noise, some near-flat (their t-stat windows have subnormal
    variance quotients) and some very short."""
    import numpy as np

    sigs = []
    for _ in range(n):
        kind = rng.random()
        if kind < 0.5:
            n_ev = int(rng.integers(20, 220))
            lv = rng.normal(90.0, 12.0, n_ev)
            dw = rng.integers(6, 28 if rna else 13, n_ev)
            x = np.repeat(lv, dw) + rng.normal(0, 1.5, int(dw.sum()))
            sig = np.clip(np.rint(x * 8192.0 / 1400.0 - 5.0), -30000, 30000)
        elif kind < 0.75:
            sig = rng.integers(300, 900, int(rng.integers(500, 6000)))
        elif kind < 0.9:
            n_s = int(rng.integers(100, 2000))
            sig = np.full(n_s, 512) + rng.integers(-2, 3, n_s)
        else:
            sig = rng.integers(-30000, 30000, int(rng.integers(2, 200)))
        sigs.append(sig.astype(np.int16))
    return sigs


def polya_reads(rng, n: int, adaptor=(3_000, 4_000), polya=(800, 1_500),
                tail=(2_000, 3_000)) -> list:
    """Short direct-RNA-shaped i16 signals (digitisation 8192, offset 10,
    range 1400): an adaptor at 20 pA, a polyA at 62 pA, then noisy 80-130
    pA steps of 20-45 samples; `adaptor`, `polya` and `tail` are the
    half-open ranges of each stretch's samples."""
    import numpy as np

    sigs = []
    for _ in range(n):
        n_t = int(rng.integers(*tail))
        steps = np.repeat(rng.uniform(80.0, 130.0, n_t // 20 + 1), rng.integers(20, 45, n_t // 20 + 1))
        pa = np.concatenate([rng.normal(20.0, 2.0, int(rng.integers(*adaptor))),
                             rng.normal(62.0, 2.0, int(rng.integers(*polya))),
                             steps[:n_t] + rng.normal(0.0, 1.5, min(n_t, steps.size))])
        sigs.append(np.clip(np.rint(pa * 8192.0 / 1400.0 - 10.0), -32000, 32000).astype(np.int16))
    return sigs


def host_stage_batch(seed: int, rna: bool, S: int = 8_192, n: int = 64):
    """The batch phase 9 holds the eventizer and polyA kernels to their
    plain versions on: n reads of at most S samples, in (B, S) i16 rows
    with nsamples (B,) i32 and digitisation, offset, range (B,) f64. Most
    are the fuzz mix and short polyA-shaped reads; the rest are a read of
    S - 100 samples stepping to a new random level every 3 samples (with
    DNA's windows its events overflow the cap S // 4; uniform noise gives
    only about one event in 5.4 samples), a noiseless stepped read (a
    window astride a step has two constant halves, so its variance
    quotient combined_var / w is subnormal and its t-stat huge but
    finite), a pure-noise read (the adaptor scan fails), a flat read shorter than the polyA scan's rolling window,
    a polyA-shaped read with a 300-sample polyA, and an empty read."""
    import numpy as np

    rng = np.random.default_rng(seed)
    steps3 = np.repeat(rng.integers(-20000, 20000, S // 3), 3)[: S - 100]
    special = [(steps3 + rng.integers(-3, 4, steps3.size)).astype(np.int16),
               np.repeat(rng.integers(300, 900, 60), 20).astype(np.int16),
               rng.integers(300, 900, 6_000).astype(np.int16),
               np.full(1_500, 300, np.int16),
               polya_reads(rng, 1, polya=(300, 301))[0],
               np.zeros(0, np.int16)]
    n_pa = (n - len(special)) // 3
    sigs = fuzz_reads(rng, n - len(special) - n_pa, rna) + polya_reads(rng, n_pa) + special
    sig = np.zeros((n, S), np.int16)
    ns = np.zeros(n, np.int32)
    for b, x in enumerate(sigs):
        x = x[:S]
        sig[b, : x.size] = x
        ns[b] = x.size
    return (sig, ns, np.full(n, 8192.0), np.where(np.arange(n) % 2, 10.0, 5.0),
            np.full(n, 1400.0))


def _plane(sigs, S: int, offset=(5.0, 10.0)):
    """(B, S) i16 rows of sigs, zero-padded, with nsamples (B,) i32 and
    digitisation, offset (alternating), range (B,) f64."""
    import numpy as np

    n = len(sigs)
    sig = np.zeros((n, S), np.int16)
    ns = np.zeros(n, np.int32)
    for b, x in enumerate(sigs):
        sig[b, : x.size] = x[:S]
        ns[b] = min(x.size, S)
    return (sig, ns, np.full(n, 8192.0), np.where(np.arange(n) % 2, *offset),
            np.full(n, 1400.0))


def edge_event_batch(seed: int, rna: bool, S: int = 1_000):
    """The eventizer's ragged edges in one batch of 37 reads (B not a
    multiple of 8, so the wrapper pads it to 40 lanes; its first 32
    rows are one whole warp) over S = 1,000 samples, a multiple of
    neither ring tile (64 and 32 steps): reads of 0, 1, 2 samples, at
    and around w1, 2 * w2 and the tiles, of S samples (model-like and
    noise), a read of S stepping every 3 samples (with DNA windows its
    events overflow the cap S // 4), a noiseless stepped read, and the
    fuzz mix cut to S."""
    import numpy as np

    from sigfish_tpu_torch.ops.events import DNA_PARAMS, RNA_PARAMS

    rng = np.random.default_rng(seed)
    prm = RNA_PARAMS if rna else DNA_PARAMS
    w1, w2 = prm["window_length1"], prm["window_length2"]
    lens = [0, 1, 2, w1, 2 * w1, 2 * w2 - 1, 2 * w2, 2 * w2 + 1, 31, 32, 33, 127, 128, 129,
            161, S - 1, S, S]
    sigs = [np.clip(np.rint(np.repeat(rng.normal(90.0, 12.0, n // 8 + 1),
                                      8)[:n] * 8192.0 / 1400.0 - 5.0 + rng.normal(0, 9.0, n)),
                    -30000, 30000).astype(np.int16) for n in lens[:-1]]
    sigs.append(rng.integers(300, 900, S).astype(np.int16))
    steps3 = np.repeat(rng.integers(-20000, 20000, S // 3 + 1), 3)[:S]
    sigs.append((steps3 + rng.integers(-3, 4, S)).astype(np.int16))
    sigs.append(np.repeat(rng.integers(300, 900, S // 20), 20).astype(np.int16))
    sigs += fuzz_reads(rng, 37 - len(sigs), rna)
    return _plane(sigs, S)


def edge_polya_batch(seed: int, S: int = 8_292):
    """The polyA scan's ragged edges in one batch of 37 reads over S =
    8,292 samples (not a multiple of the 256-step ring tile): reads of
    0, 1, 1,999, 2,000 (the rolling window) and 2,001 samples, noise and
    a flat read (no adaptor), adaptor and polyA with a tail of 0 to 200
    samples (the last walk as short as the rolling window lets it be: the
    adaptor ends at least 1,002 samples before n), a polyA-shaped read
    cut at S, and direct-RNA-shaped reads."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sigs = [rng.integers(300, 900, n).astype(np.int16) for n in (0, 1, 1_999, 2_000, 2_001)]
    sigs += [rng.integers(-100, 1300, 7_000).astype(np.int16), np.full(6_000, 300, np.int16)]
    for tail in (0, 1, 60, 200):
        sigs += polya_reads(rng, 2, adaptor=(3_000, 4_000), polya=(1_200, 1_600),
                            tail=(tail, tail + 1))
    sigs += polya_reads(rng, 1, adaptor=(4_000, 4_001), polya=(2_000, 2_001),
                        tail=(3_000, 3_001))
    sigs += polya_reads(rng, 37 - len(sigs))
    return _plane(sigs, S, offset=(10.0, 10.0))


def contig_of(truth: dict) -> str:
    """The one contig of make_workload's truth."""
    return next(iter(truth.values()))[0]


def write_truth_paf(path: str, truth: dict, lengths: dict, ids=None) -> None:
    """A truth PAF of the reads' origins: one primary line a read (ids in
    their order, or all of truth), with the strand, contig, contig length
    (lengths[contig]), start and end columns and tp:A:P that eval and the
    trainer's case loaders read."""
    with open(path, "w") as f:
        for rid in truth if ids is None else ids:
            contig, strand, lo, hi = truth[rid]
            f.write(f"{rid}\t0\t0\t0\t{strand}\t{contig}\t{lengths[contig]}\t{lo}\t{hi}\t0\t0"
                    "\t60\ttp:A:P\n")


def subset_blow5(bl: str, out: str, keep, header=None) -> None:
    """Copy the records whose read id is in `keep` into a new BLOW5
    (header: its header_data, genomic_dna by default)."""
    from sigfish_tpu_torch.io.blow5 import Slow5File, Slow5Writer

    header = header or DNA_HEADER
    with Slow5File(bl) as src, Slow5Writer(out, header_data=header) as dst:
        for rec in src:
            if rec.read_id in keep:
                dst.write_record(rec)


def run_port(fa: str, bl: str, device: str, state=None, profile: bool = False,
             ref_chunk: int = 0, **kw):
    """run_dtw over a whole file; returns (PAF text, Core, seconds).
    profile=True runs the host stages one by one with their timers
    (--profile-cpu) and drains each batch before the next; on the card
    the Core then also records CUDA events around each route's device
    work (Core.spans, Core.span_seconds). kw: other Options (phase 7's
    RNA_OPT), over the DNA run's -p 50 -q 250."""
    from sigfish_tpu_torch.runtime import pipeline as pl

    kw = {"prefix_size": PREFIX, "query_size": W, **kw}
    opt = pl.Options(batch_size=BATCH, num_thread=THREADS, device=device, profile=profile,
                     ref_chunk=ref_chunk, **kw)
    core = pl.Core(fa, bl, opt, state=state)
    out = io.StringIO()
    t0 = time.time()
    pl.run_dtw(core, out)
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
    dt = time.time() - t0
    core.close()
    return out.getvalue(), core, dt


def core_state(fa: str, bl: str, **kw):
    """The Core state (pore model, reference layout) of a FASTA, built
    once; kw as run_port's."""
    from sigfish_tpu_torch.runtime.pipeline import Core, Options

    kw = {"prefix_size": PREFIX, "query_size": W, **kw}
    probe = Core(fa, bl, Options(num_thread=1, device="cuda", **kw))
    state, pad_q = probe.state, probe.pad_q
    probe.close()
    return state, pad_q


def overlap_share(paf: str, truth: dict) -> float:
    """Share of reads whose PAF target interval, on the right contig and
    strand, overlaps the interval the read was drawn from."""
    hit = 0
    for line in paf.splitlines():
        f = line.split("\t")
        contig, strand, lo, hi = truth[f[0]]
        if f[5] == contig and f[4] == strand and int(f[7]) < hi and int(f[8]) > lo:
            hit += 1
    return hit / len(truth)


def bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32).cpu(), b.contiguous().view(torch.int32).cpu()
    )


def abs_err(a, b) -> float:
    """max |a - b|, with equal values (infinities included) counted 0."""
    import torch

    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def once_ms(fn):
    """(device ms, result) of one call of fn() (CUDA events), no warm-up."""
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def bound(ops: float, nbytes: float, issue_rate: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of the operations
    over the f32 issue rate (instructions per second) and the bytes over
    the memory rate."""
    t_ops, t_bytes = ops / issue_rate, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def ptxas_instances(report: str) -> list[tuple[str, int, int, int]]:
    """(entry, registers, spill store bytes, spill load bytes) of each
    kernel entry in an nvcc -Xptxas -v report."""
    import re

    out, entry, spills = [], None, (0, 0)
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.append((entry, int(m.group(1)), *spills))
            entry, spills = None, (0, 0)
    return out


def ptxas_table(report: str) -> list[dict]:
    """Each kernel entry of an nvcc -Xptxas -v report: its short name (the
    kernel's name), registers, static shared memory and spill bytes."""
    import re

    out, entry, spills = [], None, (0, 0)
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            # _ZN..._GLOBAL__N_..._13prefix_kernelEPKs...: the first lower-case name
            k = re.search(r"([a-z][a-z_]*_kernel)", m.group(1))
            entry = m.group(1) if k is None else k.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(dict(entry=entry, registers=int(m.group(1)),
                            smem=int(smem.group(1)) if smem else 0,
                            spill_stores=spills[0], spill_loads=spills[1]))
            entry, spills = None, (0, 0)
    return out


def wavefront_instance(entry: str) -> dict | None:
    """Q, rows a lane, warps and the std / carry / FS0 flags of a
    wavefront_kernel<ROWS, WARPS, STD, CARRY, FS0> entry's mangled name."""
    import re

    m = re.search(r"wavefront_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])E", entry)
    if not m:
        return None
    rows, warps, std, carry, fs0 = (int(g) for g in m.groups())
    return dict(Q=32 * rows * warps, rows=rows, warps=warps, std=std, carry=carry, fs0=fs0)


def dtw_argv(fa: str, bl: str, rna: bool = False) -> list[str]:
    """The `dtw` arguments of phase 4's run_port call (phase 7's with
    rna=True): the file pair, -K, -t, -p and -q."""
    opt = (["--rna", "-q", str(RNA_OPT["query_size"]), "-p", str(RNA_OPT["prefix_size"])]
           if rna else ["-p", str(PREFIX), "-q", str(W)])
    return [fa, bl, "-K", str(BATCH), "-t", str(THREADS), *opt]


def stripe(paf: str, i: int, n: int) -> str:
    """The lines of paf whose read's record index is i mod n, in file
    order: the generators name record r read%05d."""
    return "".join(ln + "\n" for ln in paf.splitlines() if int(ln.split("\t")[0][4:]) % n == i)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_procs(cmds: list[list[str]], d: str, tag: str) -> tuple[list[int], list[str], float]:
    """Run `python -m sigfish_tpu_torch.cli dtw CMD` for each command, side
    by side, from the checkout's root, each one's stderr into a file
    under d. Returns (exit codes, stderr texts, wall seconds). Every
    process is stopped before it returns; past HOST_TIMEOUT_S the phase
    fails."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("SIGFISH_")}
    errs = [os.path.join(d, f"{tag}{i}.err") for i in range(len(cmds))]
    procs = []
    t0 = time.time()
    try:
        for cmd, err in zip(cmds, errs):
            with open(err, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "sigfish_tpu_torch.cli", "dtw", *cmd], cwd=REPO,
                    env=env, stdout=subprocess.DEVNULL, stderr=fh))
        for p in procs:
            p.wait(timeout=max(1.0, t0 + HOST_TIMEOUT_S - time.time()))
    except subprocess.TimeoutExpired:
        fail(f"phase 11: {tag} ran past {HOST_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dt = time.time() - t0
    texts = []
    for e in errs:
        with open(e) as fh:
            texts.append(fh.read())
    return [p.returncode for p in procs], texts, dt


def run_hosts(argv: list[str], n: int, d: str, tag: str) -> tuple[list[str], list[str], float]:
    """An n-host cluster over argv on the card (-v 5: each host prints
    its kernel launches), host i writing -o d/<tag><i>.out. A port taken
    again before host 0 binds it retries once. Returns (outputs, stderr
    texts, wall seconds); fails on any non-zero exit."""
    for attempt in range(2):
        port = free_port()
        outs = [os.path.join(d, f"{tag}{i}.out") for i in range(n)]
        cmds = [[*argv, "--hosts", str(n), "--host-id", str(i), "--coordinator",
                 f"localhost:{port}", "-o", outs[i], "-v", "5"] for i in range(n)]
        rcs, texts, dt = run_procs(cmds, d, tag)
        if attempt or not any("EADDRINUSE" in t or "ddress already in use" in t for t in texts):
            break
    for i, (rc, t) in enumerate(zip(rcs, texts)):
        if rc != 0:
            fail(f"phase 11: {tag}, host {i} exited {rc}:\n{t[-3000:]}")
    return outs, texts, dt


def host_report(text: str) -> dict:
    """A host's "Data processing time" and kernel launches (the CLI's -v 5
    debug line) from its stderr."""
    out = {"processing_s": None, "launches": {}}
    for ln in text.splitlines():
        if "Data processing time:" in ln:
            out["processing_s"] = float(ln.split(":")[-1].split()[0])
        elif "kernel launches:" in ln:
            out["launches"] = {k: int(v) for k, v in
                               (kv.split("=") for kv in ln.split("kernel launches:")[1].split())}
    return out


def counters_text(core) -> str:
    """The counters of the CLI's final report, as its lines print them."""
    return (f"total entries: {core.total_reads}\tprefix fail: {core.prefix_fail}"
            f"\tignored: {core.ignored}\ttoo short: {core.too_short}")


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
    from sigfish_tpu_torch.scripts import bench_carry
    from sigfish_tpu_torch.scripts.timing import median_ms, sm_clock_mhz
    from sigfish_tpu_torch.ops import alu_peak as apm
    from sigfish_tpu_torch.ops import layout
    from sigfish_tpu_torch.ops import sdtw_wavefront as wfm
    from sigfish_tpu_torch.ops.sdtw_wavefront import OPS_PER_CELL
    from sigfish_tpu_torch.ops.candidates_dev import topk_candidates, window_top5
    from sigfish_tpu_torch.ops import chunked_ref as crm
    from sigfish_tpu_torch.ops.chunked_ref import (
        chunk_segment_diags,
        prepare_chunked_inputs,
        sdtw_wavefront_chunked_top5,
    )

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
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clk_max = sm_clock_mhz()[1]
    issue = n_sm * F32_ISSUE_PER_SM_CLK * clk_max * 1e6
    print(f"f32 issue rate, the bounds' operations rate: {n_sm} SMs x {F32_ISSUE_PER_SM_CLK} per "
          f"clock x {clk_max:.0f} MHz = {issue / 1e12:.3f}e12 instructions/s")

    # ---------------------------------------------------------------- 2
    phase("2 build")
    t0 = time.time()
    reports = kbuild.build_all()
    print(f"kernels {', '.join(reports)} built in {time.time() - t0:.2f} s")
    for kname, rep in reports.items():
        insts = ptxas_instances(rep)
        other = []
        for entry, regs, st, ld in insts:
            wi = wavefront_instance(entry)
            if wi is not None and wi["Q"] == 512:
                print(f"  {kname} Q=512 rows={wi['rows']} warps={wi['warps']} std={wi['std']} "
                      f"carry={wi['carry']} fs0={wi['fs0']}: {regs} registers, {st} bytes spill "
                      f"stores, {ld} bytes spill loads")
            else:
                other.append((regs, st + ld))
        if other:
            print(f"  {kname}: {len(other)} {'other ' if len(other) < len(insts) else ''}entries, "
                  f"at most {max(r for r, _ in other)} registers, "
                  f"{sum(b for _, b in other)} bytes spilled in all")
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

        state, pad_q = core_state(fa, bl)
        R = state.ref_cat.shape[0]
        ypad_h, rspad_h, D = layout.prepare_wavefront_inputs(state.ref_cat, state.reset, pad_q)
        ypad = torch.from_numpy(ypad_h).to(dev)
        rspad = torch.from_numpy(rspad_h).to(dev)
        u_h, valid_h = layout.build_column_maps(state.offsets, R, track_sizes=state.track_sizes)
        print(f"reference: {len(state.track_sizes)} tracks, R={R} columns, D={D} diagonals, Q={pad_q}")

        # phase 7's direct-RNA workload, made here: phases 3 and 5 run the
        # Q=512 instances over its reference
        work7 = os.path.join(work, "rna")
        os.makedirs(work7)
        t0 = time.time()
        fa7, bl7, truth7 = make_rna_workload(work7, N7_TX, N7_READS, SEED + 7)
        state7, pad_q7 = core_state(fa7, bl7, **RNA_OPT)
        W7 = RNA_OPT["query_size"]
        R7 = state7.ref_cat.shape[0]
        ypad7_h, rspad7_h, D7 = layout.prepare_wavefront_inputs(state7.ref_cat, state7.reset, pad_q7)
        ypad7 = torch.from_numpy(ypad7_h).to(dev)
        rspad7 = torch.from_numpy(rspad7_h).to(dev)
        print(f"RNA workload: {N7_READS} reads over {N7_TX} transcripts, {len(state7.track_sizes)} "
              f"tracks ('+' only), R={R7} columns, D={D7} diagonals, Q={pad_q7}, made in "
              f"{time.time() - t0:.2f} s")

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
        carry_err = 0.0
        full = [rng.standard_normal(W).astype(np.float32) for _ in range(B3)]
        q_full = layout.make_query_batch(full, pad_q=pad_q)[0]
        cuts = [0, 20_000, 40_007, D]  # three uneven segments
        warps_q = [w for w in wfm.WARPS if pad_q % (32 * w) == 0]

        def check_warps(label, q, sl, std, y=ypad, r=rspad, lane=W - 1):
            """Every warps instance against one plain run; returns the
            scores of the instance the wrapper picks for this B, and the
            largest error."""
            Q, Dy = q.shape[1], y.shape[1]
            t0 = time.time()
            want = wfm.wavefront_plain(q, y, r, lane, sl, std)
            torch.cuda.synchronize()
            plain_s = time.time() - t0
            picked = wfm.wavefront_warps(q.shape[0], Q)
            worst = 0.0
            for w in [w for w in wfm.WARPS if Q % (32 * w) == 0]:
                got = wfm.sdtw_wavefront(q, y, r, lane, start_lanes=sl, std=std, warps=w)
                torch.cuda.synchronize()
                ok = bits_equal(got, want)
                err = abs_err(got, want)
                worst = max(worst, err)
                print(f"wavefront {label}: B={q.shape[0]} Q={Q} D={Dy} warps={w}"
                      f"{'*' if w == picked else ''} bitwise_equal={ok} max_abs_err={err}")
                if not ok:
                    fail(f"wavefront kernel (warps={w}) differs from its plain version ({label}, "
                         f"B={q.shape[0]}, Q={Q})")
                if w == picked:
                    kept = got
            print(f"  (plain {plain_s:.1f} s; * the instance wavefront_warps picks)")
            return kept, worst

        def check_carry(label, q, sl, std, one, cuts, y=ypad, r=rspad, lane=W - 1):
            """The carry mode chained over `cuts`, every warps instance and
            one chain mixing warp counts, against one plain carry chain:
            scores, and the state under carry_state_mask; the chained
            scores against `one`, the one-shot launch's. Returns the
            largest error."""
            B, Q = q.shape
            t0 = time.time()
            plain, st_p = [], wfm.carry_fresh_state(B, Q, dev)
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                plain.append(wfm.wavefront_plain(q, y[:, lo:hi], r[:, lo:hi], lane, sl, std, *st_p))
                st_p = plain[-1][1:]
            torch.cuda.synchronize()
            plain_s = time.time() - t0
            masks = wfm.carry_state_mask(sl, B, Q, dev)
            warps_q = [w for w in wfm.WARPS if Q % (32 * w) == 0]
            mixed = (warps_q[-1], warps_q[0], warps_q[1])
            worst = 0.0
            for chain in [(w,) * len(plain) for w in warps_q] + [mixed]:
                st_k, parts, ok = wfm.carry_fresh_state(B, Q, dev), [], True
                for (lo, hi), w, want in zip(zip(cuts[:-1], cuts[1:]), chain, plain):
                    out_k = wfm.sdtw_wavefront_carry(q, y[:, lo:hi], r[:, lo:hi], *st_k,
                                                     lane, sl, std, warps=w)
                    torch.cuda.synchronize()
                    ok = ok and bits_equal(out_k[0], want[0])
                    worst = max(worst, abs_err(out_k[0], want[0]))
                    for a, b, m in zip(out_k[1:], want[1:], masks):
                        ok = ok and bits_equal(a[m], b[m])
                        worst = max(worst, abs_err(a[m], b[m]))
                    st_k = out_k[1:]
                    parts.append(out_k[0])
                same = bits_equal(torch.cat(parts, dim=1), one)
                print(f"carry {label}: Q={Q} segments {cuts}, warps per segment {chain}, scores "
                      f"and masked state bitwise_equal={ok}, chained == one launch: {same}, "
                      f"max_abs_err={worst}")
                if not ok:
                    fail(f"carry kernel differs from its plain version ({label}, Q={Q}, warps {chain})")
                if not same:
                    fail(f"chained carry launches differ from one wavefront launch ({label}, "
                         f"Q={Q}, warps {chain})")
            print(f"  (plain carry chain {plain_s:.1f} s)")
            return worst

        for label, q_h, fs_h, std in (
            ("full-length", q_full, None, False),
            ("clipped", qb_k, fs, False),
            ("std", qb_k, fs, True),
        ):
            q = torch.from_numpy(q_h).to(dev)
            sl = None if fs_h is None else torch.from_numpy(fs_h).to(dev)
            got, err = check_warps(label, q, sl, std)
            max_err = max(max_err, err)
            if label == "clipped":
                scores = got
            carry_err = max(carry_err, check_carry(label, q, sl, std, got, cuts))
            del got

        # Q=512, the RNA path's width, over the RNA reference's first
        # CUT3_DIAGS diagonals: full-length reads without start lanes, and
        # a batch mixing full-length rows with clipped rows (qlen 25 up to
        # W-1, start lanes up to W-25) whose carry chain takes the start
        # lanes on every segment
        y3 = ypad7[:, :CUT3_DIAGS].contiguous()
        r3 = rspad7[:, :CUT3_DIAGS].contiguous()
        qlens3 = np.full(B3, W7, np.int32)
        qlens3[1::3] = rng.integers(25, W7, size=qlens3[1::3].size)
        qlens3[1] = 25
        q3, qlens3, _ = layout.make_query_batch(
            [rng.standard_normal(int(n)).astype(np.float32) for n in qlens3], pad_q=pad_q7)
        q3, fs3 = layout.shift_queries_for_clip(q3, qlens3, W7 - 1)
        q3_full = rng.standard_normal((B3, pad_q7)).astype(np.float32)
        cuts3 = [0, 8_000, 16_007, CUT3_DIAGS]
        for label, q_h, fs_h in (("Q=512 full-length", q3_full, None),
                                 ("Q=512 clipped", q3, fs3)):
            q = torch.from_numpy(q_h).to(dev)
            sl = None if fs_h is None else torch.from_numpy(fs_h).to(dev)
            got, err = check_warps(label, q, sl, False, y3, r3, W7 - 1)
            max_err = max(max_err, err)
            if sl is not None:
                carry_err = max(carry_err, check_carry(label, q, sl, False, got, cuts3, y3, r3,
                                                       W7 - 1))
            del got
        del y3, r3

        # a small batch of clipped reads: 16 rows (the one-shot 4-warp instance)
        B16 = 16
        qlens16 = rng.integers(25, W, size=B16).astype(np.int32)
        q16, qlens16, _ = layout.make_query_batch(
            [rng.standard_normal(int(n)).astype(np.float32) for n in qlens16], pad_q=pad_q)
        q16, fs16 = layout.shift_queries_for_clip(q16, qlens16, W - 1)
        err = check_warps("clipped", torch.from_numpy(q16).to(dev), torch.from_numpy(fs16).to(dev),
                          False)[1]
        max_err = max(max_err, err)

        # the chunked top-5 (carry kernel + fold) against the one-shot
        # kernel + window_top5, on the card
        valid_d = torch.from_numpy(valid_h).to(dev)
        yps, rps, vs, Ds3, nwin = prepare_chunked_inputs(
            state.ref_cat, state.reset, valid_h, pad_q, W, target=16_000)
        q = torch.from_numpy(q_full).to(dev)
        got = sdtw_wavefront_chunked_top5(
            q, torch.from_numpy(yps).to(dev), torch.from_numpy(rps).to(dev),
            torch.from_numpy(vs).to(dev), W - 1, W, nwin)
        want = window_top5(wfm.sdtw_wavefront(q, ypad, rspad, W - 1), valid_d, R, W, pack=True)
        ok = bits_equal(got, want)
        print(f"chunked top-5: {yps.shape[0]} segments of {Ds3} diagonals, "
              f"bitwise_equal to window_top5(one-shot)={ok}")
        if not ok:
            fail("the chunked top-5 on the card differs from the one-shot route's")

        # the chunked route's clip fold on the card against topk_candidates
        # of the one-shot kernel's scores on the card: clipped reads of
        # qlen 25, 97 (which divides neither W nor Ds) and W-1 beside
        # full-length reads in one carry chain with start lanes, over the
        # phase-4 reference with a flat stretch across two segment
        # boundaries and flat queries, so that windows split by a
        # boundary hold equal minima on both sides
        u_d = torch.from_numpy(u_h).to(dev)
        ref_t = state.ref_cat.copy()
        for b in (Ds3, 2 * Ds3):
            c0 = b - (W - 1)  # the first column of segment b / Ds3
            ref_t[c0 - 400 : c0 + 400] = 0.25
        yp_t, rp_t, _ = layout.prepare_wavefront_inputs(ref_t, state.reset, pad_q)
        yps_t, rps_t, _, _, _ = prepare_chunked_inputs(ref_t, state.reset, valid_h, pad_q, W,
                                                       target=16_000)
        ts_t, ls_t = crm.prepare_clip_inputs(state.offsets, state.track_sizes, W, *vs.shape)
        qlens_t = np.tile(np.array([W, 25, 97, W - 1, W, 97, 25, W - 1], np.int32), 4)
        qlist = [rng.standard_normal(int(n)).astype(np.float32) for n in qlens_t]
        for i in range(0, qlens_t.size, 3):
            qlist[i][:] = 0.25
        q_t, qlens_t, _ = layout.make_query_batch(qlist, pad_q=pad_q)
        q_t, fs_t = layout.shift_queries_for_clip(q_t, qlens_t, W - 1)
        rows_t = np.where(qlens_t != W)[0]
        bases_t, nwin_t = crm.clip_window_bases(state.track_sizes, qlens_t[rows_t])
        td = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        clip_t = crm.ClipFold(td(rows_t), td(qlens_t[rows_t]), td(bases_t), nwin_t, td(ts_t),
                              td(ls_t), td(vs), W)
        crm.carry_chain(td(q_t), td(yps_t), td(rps_t), W - 1, [clip_t], td(fs_t))
        got = clip_t.top5()
        one_t = wfm.sdtw_wavefront(td(q_t), td(yp_t), td(rp_t), W - 1, start_lanes=td(fs_t))
        want = topk_candidates(one_t[td(rows_t)][:, W - 1 : W - 1 + R], td(qlens_t[rows_t]),
                               u_d, valid_d, R, reindex=False, pack=True)
        ok = bits_equal(got, want)
        ties = [int((v == v.min()).sum()) for v in one_t[td(rows_t)][:, W - 1 : W - 1 + R]]
        print(f"clip fold: {rows_t.size} clipped rows (qlens {sorted(set(qlens_t[rows_t].tolist()))}), "
              f"{yps_t.shape[0]} segments of {Ds3} diagonals, most columns at a row's minimum "
              f"{max(ties)}, bitwise_equal to topk_candidates(one-shot)={ok}")
        if not ok:
            fail("the clip fold on the card differs from topk_candidates of the one-shot kernel")
        del one_t, clip_t

        # the candidate reduction on the card against CPU copies, on the
        # kernel's scores and on small-integer scores full of ties
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
        wfm.sdtw_wavefront.launches_by_warps = dict.fromkeys(wfm.WARPS, 0)
        paf, core, dt = run_port(fa, bl, "cuda", state=state)
        launches = wfm.sdtw_wavefront.launches
        counts4, dt4 = counters_text(core), dt
        by_warps4 = {w: n for w, n in wfm.sdtw_wavefront.launches_by_warps.items() if n}
        n_lines = len(paf.splitlines())
        print(f"run_dtw on cuda: {core.total_reads} reads, {n_lines} PAF lines, "
              f"{dt:.3f} s, {core.total_reads / dt:.1f} reads/s end to end; "
              f"wavefront launches: {launches} (by warps per read: {by_warps4})")
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
              f"device + backtrack + PAF {pcore.dtw_time:.3f} s; device time of the one-shot "
              f"route {pcore.span_seconds('oneshot'):.3f} s in {len(pcore.spans['oneshot'])} "
              f"batches (CUDA events)")
        if ppaf != paf:
            fail("the --profile-cpu run's PAF differs from the overlapped run's")

        by_id = {ln.split("\t")[0]: ln for ln in paf.splitlines()}
        keep = [f"read{i:05d}" for i in range(SUBSET)]
        n_clip = sum(1 for i in range(SUBSET) if i % 10 == 9)
        sub_bl = os.path.join(work, "subset.blow5")
        subset_blow5(bl, sub_bl, set(keep))
        cpu_paf, _, cpu_dt = run_port(fa, sub_bl, "cpu", state=state)
        want4 = "".join(by_id[r] + "\n" for r in keep if r in by_id)
        ok = cpu_paf == want4
        print(f"PAF of {SUBSET} reads ({n_clip} clipped) on cpu vs cuda: "
              f"byte_identical={ok} (cpu {cpu_dt:.1f} s)")
        if not ok:
            fail("the cuda path's PAF differs from the cpu path's")

        # ------------------------------------------------------------ 5
        phase("5 times")
        from sigfish_tpu_torch.scripts import bench_alu_peak

        # the ALU probe through its entry point, counted as its own path
        apm.alu_peak.launches = 0
        probe = bench_alu_peak.main(["--iters", str(PROBE_ITERS)])
        probe_launches = apm.alu_peak.launches
        if probe_launches <= 0:
            fail("the ALU probe launched no kernel")
        # the ceiling of the sweep: the mix modes' best rate in wavefront
        # steps, one step being one DP cell (ops/alu_peak.py)
        sol = probe["ceiling_gsteps"]
        print(f"ALU probe ({probe_launches} launches): "
              + ", ".join(f"{m} {g:.1f}" for m, g in probe["peak_gops"].items())
              + f" Gop/s (the JAX probe's units: a roll counts one op per value); mix2/mix "
              f"{probe['mix2_over_mix']:.3f}; ceiling max(mix, mix2) = {sol:.1f} Gstep/s; "
              f"card: {smi}")
        x = torch.from_numpy(np.random.default_rng(0).random((BATCH, apm.Q), np.float32)).to(dev)
        probe_err = 0.0
        for mode in apm.MODES:
            got = apm.alu_peak(x, mode, PROBE_ITERS)
            torch.cuda.synchronize()
            plain_t, want = once_ms(lambda: apm.alu_peak_plain(x, mode, PROBE_ITERS))
            if mode == "mix":
                probe_plain_ms = plain_t
            ok = bits_equal(got, want)
            probe_err = max(probe_err, abs_err(got, want))
            print(f"alu_peak {mode}: B={BATCH} Q={apm.Q} iters={PROBE_ITERS} bitwise_equal={ok}")
            if not ok:
                fail(f"the ALU probe kernel differs from its plain version ({mode})")
        probe_ms = probe["peak_ms"]["mix"]
        probe_bound_ms, probe_bound_by = bound(
            OPS_PER_CELL * apm.step_count("mix", BATCH, PROBE_ITERS), 2 * 4 * BATCH * apm.Q, issue)

        # the one-shot kernel at the main path's shape: timed, and held
        # bit for bit to the plain version's (timed) output
        rng = np.random.default_rng(SEED + 2)
        q = torch.from_numpy(rng.standard_normal((BATCH, pad_q)).astype(np.float32)).to(dev)
        ms = median_ms(lambda: wfm.sdtw_wavefront(q, ypad, rspad, W - 1), 5)
        plain_ms, want = once_ms(lambda: wfm.wavefront_plain(q, ypad, rspad, W - 1))
        for w in warps_q:
            got = wfm.sdtw_wavefront(q, ypad, rspad, W - 1, warps=w)
            ok = bits_equal(got, want)
            max_err = max(max_err, abs_err(got, want))
            print(f"wavefront B={BATCH} Q={pad_q} D={D} warps={w}: bitwise_equal={ok}")
            if not ok:
                fail(f"wavefront kernel (warps={w}) differs from its plain version at the main "
                     f"path's shape")
        del got, want
        cells = BATCH * pad_q * D
        bound_ms, bound_by = bound(OPS_PER_CELL * cells, 4 * (BATCH * pad_q + 2 * D + BATCH * D),
                                   issue)
        print(f"kernel time in the main path: about {launches * ms / 1e3:.3f} s of "
              f"run_dtw's {dt:.3f} s ({launches} launches x {ms:.3f} ms)")
        print(f"wavefront B={BATCH} Q={pad_q} D={D} warps={wfm.wavefront_warps(BATCH, pad_q)}: "
              f"{ms:.3f} ms per launch (median of 5), "
              f"{cells / ms / 1e6:.1f} Gcell/s, bound {bound_ms:.3f} ms by {bound_by} "
              f"({OPS_PER_CELL} f32 ops/cell at the issue rate), {bound_ms / ms:.1%} of the bound, "
              f"{cells / sol / 1e6:.3f} ms at the probe's {sol:.1f} Gstep/s, "
              f"plain version {plain_ms:.1f} ms; card: {smi}")

        # the carry kernel at the chunked route's shape: its first two
        # segments of the phase-4 reference, chained from a fresh state at
        # the instance carry_warps picks, each held bit for bit to the
        # plain version's: with no start lanes (the FS0 instance) the scores
        # and the four outgoing state tensors; with start lanes and one row
        # in ten clipped, as phase 6's batches have them, the scores and
        # the state under carry_state_mask. Then its table of ms per
        # segment launch by B and warps over the first segment, B=512's
        # cycles per diagonal and the SASS count (scripts/bench_carry.py)
        yps, rps, _, Ds, _ = prepare_chunked_inputs(
            state.ref_cat, state.reset, valid_h, pad_q, W, target=32768)
        if yps.shape[0] < 2:
            fail(f"the phase-4 reference gives {yps.shape[0]} segments of {Ds}; want 2")
        yps = torch.from_numpy(yps).to(dev)
        rps = torch.from_numpy(rps).to(dev)
        c_pick = wfm.carry_warps(BATCH, pad_q)
        q_h = q.cpu().numpy()
        rows_sl = np.arange(9, BATCH, 10)
        qlens_sl = np.full(BATCH, W, np.int32)
        qlens_sl[rows_sl] = rng.integers(150, W, size=rows_sl.size)
        q_sl, _, _ = layout.make_query_batch([q_h[i, :n] for i, n in enumerate(qlens_sl)],
                                             pad_q=pad_q)
        q_sl, fs_sl = layout.shift_queries_for_clip(q_sl, qlens_sl, W - 1)
        plain_times = {}
        for sl_label, q_c, sl_c in (("no start lanes", q, None),
                                    ("start lanes, one row in ten clipped", td(q_sl), td(fs_sl))):
            masks = wfm.carry_state_mask(sl_c, BATCH, pad_q, dev)
            st_k = st_p = wfm.carry_fresh_state(BATCH, pad_q, dev)
            plain_times[sl_c is not None] = []
            for s_i in range(2):
                out_k = wfm.sdtw_wavefront_carry(q_c, yps[s_i], rps[s_i], *st_k, W - 1, sl_c)
                t, out_p = once_ms(lambda: wfm.wavefront_plain(
                    q_c, yps[s_i], rps[s_i], W - 1, sl_c, False, *st_p))
                plain_times[sl_c is not None].append(t)
                pairs = [(out_k[0], out_p[0])] + [
                    (a[m], b[m]) for a, b, m in zip(out_k[1:], out_p[1:], masks)]
                ok = all(bits_equal(a, b) for a, b in pairs)
                carry_err = max([carry_err] + [abs_err(a, b) for a, b in pairs])
                print(f"carry B={BATCH} Q={pad_q} Ds={Ds} segment {s_i} "
                      f"({'fresh' if s_i == 0 else 'carried'} state), {sl_label}: scores and "
                      f"{'masked ' if sl_c is not None else ''}state bitwise_equal={ok}")
                if not ok:
                    fail(f"carry kernel differs from its plain version at the chunked route's "
                         f"shape (segment {s_i}, {sl_label})")
                st_k, st_p = out_k[1:], out_p[1:]
        del out_k, out_p, st_k, st_p, pairs, q_c, sl_c
        carry_bench = bench_carry.main(y=yps[0], r=rps[0])
        del yps, rps
        c_ms_fs0 = carry_bench["table"][str(BATCH)][str(c_pick)]
        c_ms_sl = carry_bench["b512_start_lanes"][str(c_pick)]
        c_ms1 = carry_bench["table"][str(BATCH)]["1"]
        c_cells = BATCH * pad_q * Ds
        c_bytes = 4 * (BATCH * pad_q + 2 * Ds + BATCH * Ds + 2 * (2 * BATCH * pad_q + 2 * pad_q))
        c_bound_ms, c_bound_by = bound(OPS_PER_CELL * c_cells, c_bytes, issue)
        c_ceil_ms = c_cells / sol / 1e6
        clk_max = carry_bench["clock_max_mhz"]
        print(f"carry B={BATCH} Q={pad_q} Ds={Ds} warps={c_pick}: {c_ms_fs0:.3f} ms per segment "
              f"launch with no start lanes ({c_ms1:.3f} at 1 warp), {c_ms_sl:.3f} with start lanes, "
              f"{c_cells / c_ms_fs0 / 1e6:.1f} Gcell/s, bound {c_bound_ms:.3f} ms by {c_bound_by} "
              f"({c_bound_ms / c_ms_fs0:.1%} of it, {c_bound_ms / c_ms_sl:.1%} with start lanes), "
              f"{c_ceil_ms:.3f} ms at the probe's {sol:.1f} Gstep/s; "
              f"{c_ms_fs0 * 1e-3 * clk_max * 1e6 / Ds:.1f} SM cycles per diagonal against "
              f"{c_ceil_ms * 1e-3 * clk_max * 1e6 / Ds:.1f} at the probe's ceiling and "
              f"{c_bound_ms * 1e-3 * clk_max * 1e6 / Ds:.1f} at the bound ({clk_max:.0f} MHz); "
              f"SASS instructions per diagonal {carry_bench['sass_per_diagonal'] or 'not counted'}; "
              f"plain version {plain_times[False][0]:.1f} ms with no start lanes, "
              f"{plain_times[True][0]:.1f} with (fresh state; {plain_times[False][1]:.1f} / "
              f"{plain_times[True][1]:.1f} ms carried); card: {smi}")
        print(f"alu_peak mix B={BATCH} iters={PROBE_ITERS}: {probe_ms:.3f} ms per launch, bound "
              f"{probe_bound_ms:.3f} ms by {probe_bound_by} ({probe_bound_ms / probe_ms:.1%} of the "
              f"bound at the f32 issue rate), plain version {probe_plain_ms:.1f} ms; card: {smi}")
        del x

        # the one-shot kernel's ms per launch for each warps instance and
        # batch size, over the phase-4 reference (* = wavefront_warps' pick)
        print(f"one-shot ms per launch by warps per read, Q={pad_q} D={D} (median of 5; "
              f"* = the instance wavefront_warps picks); card: {smi}")
        table = {}
        q2 = torch.cat([q, q])
        for Bt in (16, 64, 128, 256, 512, 1024):
            qt = q2[:Bt].contiguous()
            row = {w: median_ms(lambda: wfm.sdtw_wavefront(qt, ypad, rspad, W - 1, warps=w), 5)
                   for w in warps_q}
            table[Bt] = row
            pick = wfm.wavefront_warps(Bt, pad_q)
            print(f"  B={Bt:4d}: " + "  ".join(
                f"warps={w}{'*' if w == pick else ' '} {t:8.3f}" for w, t in row.items()))
        clk_now, clk_max = sm_clock_mhz()
        w16 = wfm.wavefront_warps(16, pad_q)
        ms16 = table[16][w16]
        bound16_ms, bound16_by = bound(OPS_PER_CELL * 16 * pad_q * D,
                                       4 * (16 * pad_q + 2 * D + 16 * D), issue)
        print(f"B=16 cycles per diagonal at the {clk_max:.0f} MHz maximum SM clock (now "
              f"{clk_now:.0f} MHz): " + ", ".join(
                  f"warps={w} {t * 1e-3 * clk_max * 1e6 / D:.1f}" for w, t in table[16].items())
              + f"; bound {bound16_ms:.4f} ms by {bound16_by}")
        del q, q2, qt

        # the same table at Q=512 over the RNA reference (phase 7's
        # launches), and B=512's time and bound at wavefront_warps' pick
        warps_q7 = [w for w in wfm.WARPS if pad_q7 % (32 * w) == 0]
        q7 = torch.from_numpy(rng.standard_normal((BATCH, pad_q7)).astype(np.float32)).to(dev)
        print(f"one-shot ms per launch by warps per read, Q={pad_q7} D={D7} over the RNA reference "
              f"(median of 5; * = the instance wavefront_warps picks); card: {smi}")
        table7 = {}
        for Bt in (16, 64, 128, 256, 512):
            qt = q7[:Bt].contiguous()
            row = {w: median_ms(lambda: wfm.sdtw_wavefront(qt, ypad7, rspad7, W7 - 1, warps=w), 5)
                   for w in warps_q7}
            table7[Bt] = row
            pick = wfm.wavefront_warps(Bt, pad_q7)
            print(f"  B={Bt:4d}: " + "  ".join(
                f"warps={w}{'*' if w == pick else ' '} {t:8.3f}" for w, t in row.items()))
        w7 = wfm.wavefront_warps(BATCH, pad_q7)
        ms7 = table7[BATCH][w7]
        # the shape phase 7 launches, B=512 over the whole RNA reference:
        # the plain version timed once, every warps instance held to its
        # output bit for bit
        plain_ms7, want_q512 = once_ms(lambda: wfm.wavefront_plain(q7, ypad7, rspad7, W7 - 1))
        for w in warps_q7:
            got = wfm.sdtw_wavefront(q7, ypad7, rspad7, W7 - 1, warps=w)
            ok = bits_equal(got, want_q512)
            max_err = max(max_err, abs_err(got, want_q512))
            print(f"wavefront B={BATCH} Q={pad_q7} D={D7} warps={w}{'*' if w == w7 else ''}: "
                  f"bitwise_equal={ok}")
            if not ok:
                fail(f"wavefront kernel (warps={w}) differs from its plain version at the RNA "
                     f"path's shape (B={BATCH}, Q={pad_q7})")
        del got, want_q512
        cells7 = BATCH * pad_q7 * D7
        bound7_ms, bound7_by = bound(OPS_PER_CELL * cells7,
                                     4 * (BATCH * pad_q7 + 2 * D7 + BATCH * D7), issue)
        print(f"wavefront B={BATCH} Q={pad_q7} D={D7} warps={w7}: {ms7:.3f} ms per launch, "
              f"{cells7 / ms7 / 1e6:.1f} Gcell/s, bound {bound7_ms:.3f} ms by {bound7_by} "
              f"({bound7_ms / ms7:.1%} of it), {cells7 / sol / 1e6:.3f} ms at the probe's "
              f"{sol:.1f} Gstep/s, {ms7 * 1e-3 * clk_max * 1e6 / D7:.1f} SM cycles per diagonal, "
              f"plain version {plain_ms7:.1f} ms; card: {smi}")
        del q7, qt

        # ------------------------------------------------------------ 6
        phase("6 chunked reference at full width")
        # the phase-4 subset through forced small segments: card vs CPU
        t0 = time.time()
        g_paf, _, g_dt = run_port(fa, sub_bl, "cuda", state=state, ref_chunk=CPU_REF_CHUNK)
        c_paf, _, c_dt = run_port(fa, sub_bl, "cpu", state=state, ref_chunk=CPU_REF_CHUNK)
        ok = g_paf == c_paf == want4
        print(f"ref_chunk={CPU_REF_CHUNK} (segments of {chunk_segment_diags(W, CPU_REF_CHUNK)} "
              f"diagonals), {SUBSET} reads: cuda vs cpu byte_identical={ok}, and to the one-shot "
              f"PAF (cuda {g_dt:.1f} s, cpu {c_dt:.1f} s)")
        if not ok:
            fail("the chunked route's PAF on the card differs from the CPU's")

        work6 = os.path.join(work, "ecoli")
        os.makedirs(work6)
        t0 = time.time()
        fa6, bl6, truth6 = make_workload(work6, ECOLI_BASES, N6_READS, SEED + 6)
        state6, _ = core_state(fa6, bl6)
        R6 = state6.ref_cat.shape[0]
        D6 = layout.wavefront_diags(R6, pad_q)
        oneshot_gb = 4 * BATCH * D6 / 1e9
        print(f"workload: {N6_READS} reads over {ECOLI_BASES} bases, R={R6} columns, "
              f"made in {time.time() - t0:.2f} s; the one-shot (512, {D6}) scores would "
              f"take {oneshot_gb:.2f} GB")

        wfm.sdtw_wavefront.launches = 0
        wfm.sdtw_wavefront.launches_by_warps = dict.fromkeys(wfm.WARPS, 0)
        wfm.sdtw_wavefront_carry.launches = 0
        wfm.sdtw_wavefront_carry.launches_by_warps = dict.fromkeys(wfm.WARPS, 0)
        wfm.sdtw_wavefront_carry.launches_start_lanes = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        paf6, core6, dt6 = run_port(fa6, bl6, "cuda", state=state6)
        carry_launches = wfm.sdtw_wavefront_carry.launches
        carry_by_warps = {w: n for w, n in wfm.sdtw_wavefront_carry.launches_by_warps.items() if n}
        carry_start_lanes = wfm.sdtw_wavefront_carry.launches_start_lanes
        oneshot_launches = wfm.sdtw_wavefront.launches
        routes = core6.routes
        n_batches6 = -(-N6_READS // BATCH)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"run_dtw on cuda, ref_chunk=0: {core6.total_reads} reads, "
              f"{len(paf6.splitlines())} PAF lines, {dt6:.3f} s, "
              f"{core6.total_reads / dt6:.1f} reads/s end to end; card: {smi}")
        print(f"carry launches {carry_launches} (by warps per read: {carry_by_warps}; with start "
              f"lanes: {carry_start_lanes}), one-shot launches {oneshot_launches}, routes "
              f"{routes}; card: {smi}")
        print(f"peak device memory {peak_gb:.3f} GB (max_memory_allocated) beside "
              f"{oneshot_gb:.2f} GB for the one-shot (512, D) buffer alone; card: {smi}")
        if carry_launches <= 0 or routes["chunked"] <= 0:
            fail("the full-width run did not take the chunked route")
        if not carry_by_warps.get(c_pick):
            fail(f"the main fold launched no carry instance at carry_warps' pick of {c_pick} "
                 f"warps per read for B={BATCH} ({carry_by_warps})")
        if oneshot_launches:
            fail(f"the chunked run launched the one-shot kernel {oneshot_launches} times")
        if routes["clip_fold"] != n_batches6 or routes["chunked"] != n_batches6:
            fail(f"want the main fold and the clip fold once in each of {n_batches6} batches, "
                 f"each with clipped reads ({routes})")
        if carry_start_lanes != carry_launches:
            fail(f"{carry_launches - carry_start_lanes} of {carry_launches} carry launches had no "
                 f"start lanes: the clipped rows did not ride the batch's chain")
        if core6.total_reads != N6_READS:
            fail(f"{core6.total_reads} reads processed, want {N6_READS}")
        share6 = overlap_share(paf6, truth6)
        print(f"reads mapped over their origin: {share6:.4f}")
        if share6 < 0.8:
            fail(f"only {share6:.4f} of the reads map over the position they were drawn from")

        # the serial run's peak, one batch in flight, and the device
        # seconds of its chains (CUDA events)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ppaf6, pcore6, pdt6 = run_port(fa6, bl6, "cuda", state=state6, profile=True)
        peak_serial_gb = torch.cuda.max_memory_allocated() / 1e9
        fold_s = pcore6.span_seconds("chunked")
        n_fold = len(pcore6.spans["chunked"])
        print(f"--profile-cpu run ({pdt6:.3f} s, unoverlapped): main fold {fold_s:.3f} s in "
              f"{n_fold} chains (device time, CUDA events); host stages: parse "
              f"{pcore6.parse_time:.3f} s, events {pcore6.event_time:.3f} s, normalise "
              f"{pcore6.normalise_time:.3f} s; the rest {pdt6 - fold_s:.3f} s; peak device memory "
              f"{peak_serial_gb:.3f} GB beside {oneshot_gb:.2f} GB for the one-shot (512, D) "
              f"buffer; card: {smi}")
        if ppaf6 != paf6:
            fail("the --profile-cpu run's PAF differs from the overlapped run's")
        if n_fold != pcore6.routes["chunked"] or n_fold == 0:
            fail(f"{n_fold} spans do not match the routes taken ({pcore6.routes})")

        # the clip fold's cost per segment beside the carry launch's: device
        # ms (CUDA events) and host ms to queue it, for the batch's clipped
        # rows (one in ten of 512) of a B=512 segment of phase 6
        valid6 = layout.build_column_maps(state6.offsets, R6, track_sizes=state6.track_sizes)[1]
        yps6, rps6, vs6, Ds6, nwin6 = prepare_chunked_inputs(
            state6.ref_cat, state6.reset, valid6, pad_q, W)
        ts6, ls6 = crm.prepare_clip_inputs(state6.offsets, state6.track_sizes, W, *vs6.shape)
        rng6 = np.random.default_rng(SEED + 7)
        rows6 = np.arange(9, BATCH, 10)
        qlens6 = rng6.integers(150, W, size=rows6.size).astype(np.int32)
        bases6, nw6 = crm.clip_window_bases(state6.track_sizes, qlens6)
        clip6 = crm.ClipFold(td(rows6), td(qlens6), td(bases6), nw6, td(ts6), td(ls6), td(vs6), W)
        window6 = crm.WindowFold(BATCH, td(vs6), W, nwin6)
        sc6 = torch.from_numpy(rng6.random((BATCH, Ds6), np.float32)).to(dev)
        seg6 = vs6.shape[0] // 2
        fold_ms = {}
        for fname, fold in (("clip fold", clip6), ("window fold", window6)):
            host = []

            def step():
                t0 = time.perf_counter()
                fold.update(seg6, sc6)
                host.append(time.perf_counter() - t0)
            fold_ms[fname] = (median_ms(step, 20), float(np.median(host)) * 1e3)
        print(f"per segment of {Ds6} diagonals at B={BATCH}, {rows6.size} clipped rows: "
              + ", ".join(f"{k} {d:.3f} ms on the device, {h:.3f} ms on the host"
                          for k, (d, h) in fold_ms.items())
              + f"; carry launch {c_ms_sl:.3f} ms with start lanes, {c_ms_fs0:.3f} without "
              f"(warps={c_pick}); card: {smi}")
        del yps6, rps6, vs6, ts6, ls6, clip6, window6, sc6

        by_id6 = {ln.split("\t")[0]: ln for ln in paf6.splitlines()}
        keep6 = [f"read{i:05d}" for i in range(SUBSET6)]
        sub6 = os.path.join(work6, "subset.blow5")
        subset_blow5(bl6, sub6, set(keep6))
        one_paf, _, one_dt = run_port(fa6, sub6, "cuda", state=state6, ref_chunk=-1)
        want6 = "".join(by_id6[r] + "\n" for r in keep6 if r in by_id6)
        n_clip6 = sum(1 for i in range(SUBSET6) if i % 10 == 9)
        ok = one_paf == want6
        print(f"PAF of {SUBSET6} reads ({n_clip6} clipped) one-shot (ref_chunk=-1) vs chunked "
              f"on cuda: byte_identical={ok} (one-shot {one_dt:.1f} s)")
        if not ok:
            fail("the chunked route's PAF differs from the one-shot route's")

        # ------------------------------------------------------------ 7
        phase("7 direct RNA at full width")
        wfm.sdtw_wavefront.launches = 0
        wfm.sdtw_wavefront.launches_by_warps = dict.fromkeys(wfm.WARPS, 0)
        wfm.sdtw_wavefront_carry.launches = 0
        paf7, core7, dt7 = run_port(fa7, bl7, "cuda", state=state7, **RNA_OPT)
        launches7 = wfm.sdtw_wavefront.launches
        by_warps7 = {w: n for w, n in wfm.sdtw_wavefront.launches_by_warps.items() if n}
        carry7 = wfm.sdtw_wavefront_carry.launches
        print(f"run_dtw on cuda, --rna -q {W7} -p -1: {core7.total_reads} reads, "
              f"{len(paf7.splitlines())} PAF lines, {dt7:.3f} s, {core7.total_reads / dt7:.1f} "
              f"reads/s end to end; prefix fail {core7.prefix_fail}, too short {core7.too_short}, "
              f"ignored {core7.ignored}; card: {smi}")
        print(f"Q={pad_q7} one-shot launches {launches7} (by warps per read: {by_warps7}), "
              f"{ms7:.3f} ms per B={BATCH} launch at warps={w7} (phase 5), carry launches {carry7}, "
              f"routes {core7.routes}; card: {smi}")
        if launches7 <= 0 or core7.routes["oneshot"] <= 0:
            fail("the RNA run launched no one-shot wavefront kernel")
        if carry7 or core7.routes["chunked"]:
            fail("the RNA run took the chunked route; its reference is under the auto threshold")
        if core7.routes["clip_pass"] <= 0:
            fail("the RNA run's clipped reads took no clip pass")
        if core7.prefix_fail <= 0:
            fail("no RNA read fell back to the fixed query start (prefix fail)")
        if core7.total_reads != N7_READS:
            fail(f"{core7.total_reads} reads processed, want {N7_READS}")
        share7 = overlap_share(paf7, truth7)
        print(f"reads mapped over their origin: {share7:.4f}")
        if share7 < 0.75:
            fail(f"only {share7:.4f} of the RNA reads map over the transcript stretch they were "
                 "drawn from")

        ppaf7, pcore7, pdt7 = run_port(fa7, bl7, "cuda", state=state7, profile=True, **RNA_OPT)
        print(f"stages, --profile-cpu run ({pdt7:.3f} s, unoverlapped): load "
              f"{pcore7.load_db_time:.3f} s, parse {pcore7.parse_time:.3f} s, events (whole "
              f"signal) {pcore7.event_time:.3f} s, normalise with the polyA scan "
              f"{pcore7.normalise_time:.3f} s, device + "
              f"backtrack + PAF {pcore7.dtw_time:.3f} s; device time of the one-shot route "
              f"{pcore7.span_seconds('oneshot'):.3f} s in {len(pcore7.spans['oneshot'])} batches "
              f"(CUDA events); card: {smi}")
        if ppaf7 != paf7:
            fail("the RNA --profile-cpu run's PAF differs from the overlapped run's")

        by_id7 = {ln.split("\t")[0]: ln for ln in paf7.splitlines()}
        keep7 = [f"read{i:05d}" for i in range(SUBSET7)]
        sub7 = os.path.join(work7, "subset.blow5")
        subset_blow5(bl7, sub7, set(keep7), header=RNA_HEADER)
        want7 = "".join(by_id7[r] + "\n" for r in keep7 if r in by_id7)
        n_clip7 = sum(1 for i in range(SUBSET7) if i % 10 == 9)
        cpu_paf7, cpu_core7, cpu_dt7 = run_port(fa7, sub7, "cpu", state=state7, **RNA_OPT)
        ok = cpu_paf7 == want7
        print(f"PAF of {SUBSET7} RNA reads ({n_clip7} clipped, {cpu_core7.prefix_fail} prefix "
              f"fail) on cpu vs cuda: byte_identical={ok} (cpu {cpu_dt7:.1f} s)")
        if not ok:
            fail("the RNA run's PAF on the card differs from the CPU path's")
        wfm.sdtw_wavefront_carry.launches = 0
        ch_paf7, ch_core7, ch_dt7 = run_port(fa7, sub7, "cuda", state=state7, ref_chunk=32_000,
                                             **RNA_OPT)
        ok = ch_paf7 == want7 and ch_core7.routes["chunked"] > 0 and ch_core7.routes["oneshot"] == 0
        print(f"the same {SUBSET7} reads through a forced ref_chunk of 32,000 diagonals on cuda "
              f"({wfm.sdtw_wavefront_carry.launches} carry launches, routes {ch_core7.routes}): "
              f"byte_identical to the one-shot route={ok} ({ch_dt7:.1f} s)")
        if not ok:
            fail("the RNA run's chunked route differs from its one-shot route")

        # ------------------------------------------------------------ 8
        phase("8 dtw surface at full width")
        from sigfish_tpu_torch import __version__
        from sigfish_tpu_torch.eval import eval_main
        from sigfish_tpu_torch.ops import jnn
        from sigfish_tpu_torch.output import sam_header

        def reset_counts():
            for f in (wfm.sdtw_wavefront, wfm.sdtw_wavefront_carry):
                f.launches = f.launches_std = 0
                f.launches_by_warps = dict.fromkeys(wfm.WARPS, 0)
            wfm.sdtw_wavefront_carry.launches_start_lanes = 0

        def lines_of(text, ids):
            by = {ln.split("\t")[0]: ln for ln in text.splitlines()}
            return "".join(by[r] + "\n" for r in ids if r in by)

        def cuda_run(label, fa_, bl_, n_reads, truth_=None, gate=None, **kw):
            """One run_dtw over a whole file on the card: its output, Core,
            seconds and launch counts, printed with reads/s and, with a
            truth and a gate, the share mapped over the reads' origins."""
            reset_counts()
            out, core, dt = run_port(fa_, bl_, "cuda", **kw)
            counts = dict(oneshot=wfm.sdtw_wavefront.launches,
                          oneshot_std=wfm.sdtw_wavefront.launches_std,
                          carry=wfm.sdtw_wavefront_carry.launches,
                          carry_std=wfm.sdtw_wavefront_carry.launches_std)
            share = "" if truth_ is None else f", mapped over their origin {overlap_share(out, truth_):.4f}"
            print(f"{label} on cuda: {core.total_reads} reads, {len(out.splitlines())} lines, "
                  f"{dt:.3f} s, {core.total_reads / dt:.1f} reads/s end to end; prefix fail "
                  f"{core.prefix_fail}, too short {core.too_short}, ignored {core.ignored}; "
                  f"launches {counts}, routes {core.routes}{share}; card: {smi}")
            if core.total_reads != n_reads:
                fail(f"{label}: {core.total_reads} reads processed, want {n_reads}")
            if counts["oneshot"] + counts["carry"] <= 0:
                fail(f"{label}: the run launched no sDTW kernel")
            if gate is not None and overlap_share(out, truth_) < gate:
                fail(f"{label}: under {gate} of the reads map over their origin")
            return out, core, dt, counts

        def cpu_check(label, fa_, bl_sub, ids, want, **kw):
            """A CPU run over the subset's reads against the card's lines of
            those reads, byte for byte."""
            got, _, cdt = run_port(fa_, bl_sub, "cpu", **kw)
            ok = got == want
            print(f"{label}: {len(ids)} reads on cpu vs cuda byte_identical={ok} (cpu {cdt:.1f} s)")
            if not ok:
                fail(f"{label}: the card's output differs from the CPU path's")

        # DNA --sam, --from-end and eval over phase 4's workload
        sam, score, _, _ = cuda_run("--sam", fa, bl, N_READS, state=state, sam=True)
        hdr = sam_header(score.ref.ref_names, score.ref.ref_lengths, __version__)
        if len(sam.splitlines()) != n_lines:
            fail(f"--sam wrote {len(sam.splitlines())} records, phase 4 {n_lines} PAF lines")
        cpu_sam, ccore, cdt = run_port(fa, sub_bl, "cpu", state=state, sam=True)
        ok = (sam_header(ccore.ref.ref_names, ccore.ref.ref_lengths, __version__) == hdr
              and cpu_sam == lines_of(sam, keep))
        print(f"--sam header ({hdr.count(chr(10))} lines) and records of {SUBSET} reads on cpu vs "
              f"cuda byte_identical={ok} (cpu {cdt:.1f} s); {len(sam.splitlines())} records, as "
              f"phase 4's PAF lines")
        if not ok:
            fail("--sam: the card's SAM differs from the CPU path's")
        fe, _, _, _ = cuda_run("--from-end", fa, bl, N_READS, state=state, from_end=True)
        cpu_check("--from-end", fa, sub_bl, keep, lines_of(fe, keep), state=state, from_end=True)

        truth_paf = os.path.join(work, "truth.paf")
        test_paf = os.path.join(work, "phase4.paf")
        write_truth_paf(truth_paf, truth, {contig_of(truth): N_BASES})
        with open(test_paf, "w") as f:
            f.write(paf)
        ev = io.StringIO()
        stat = eval_main(truth_paf, test_paf, out=ev)
        print("eval of phase 4's PAF against the reads' origins:\n  "
              + "\n  ".join(ln for ln in ev.getvalue().splitlines()[1:7]))
        if stat.correct < 0.8 * N_READS:
            fail(f"eval: {stat.correct} of {N_READS} reads correct, under 80%")

        # R10 DNA: a phase-4-size reference, reads from the R10 9-mer table,
        # the kit sqk-lsk114 in the header and no --pore
        work8 = os.path.join(work, "r10")
        os.makedirs(work8)
        t0 = time.time()
        fa10, bl10, truth10 = make_workload(work8, N_BASES, N8_READS, SEED + 8, r10=True)
        log = io.StringIO()
        with contextlib.redirect_stderr(log):
            state10, _ = core_state(fa10, bl10)
        detected = [ln for ln in log.getvalue().splitlines() if "R10" in ln]
        print(f"R10 workload: {N8_READS} reads over {N_BASES} bases, k={state10.model.kmer_size}, "
              f"made in {time.time() - t0:.2f} s; the log: {detected}")
        if not any("Detected R10 data" in ln for ln in detected) or state10.model.kmer_size != 9:
            fail("the R10 header was not detected, or the R10 9-mer model not loaded")
        paf10, core10, _, _ = cuda_run("R10 DNA", fa10, bl10, N8_READS, truth10, 0.8, state=state10)
        if core10.pore_flag != jnn.PORE_R10:
            fail("the R10 run's polyA/pore flag is not R10")
        keep10 = [f"read{i:05d}" for i in range(SUBSET8)]
        sub10 = os.path.join(work8, "subset.blow5")
        subset_blow5(bl10, sub10, set(keep10), header=R10_HEADER)
        cpu_check("R10 DNA", fa10, sub10, keep10, lines_of(paf10, keep10), state=state10)

        # direct RNA over phase 7's transcripts: --dtw-std (the std one-shot
        # instance, then through a forced ref_chunk the std carry instance),
        # --full-ref, --invert -p 0, and RNA004
        std_opt = dict(RNA_OPT, dtw_std=True)
        std_paf, std_core, _, std_counts = cuda_run("--dtw-std", fa7, bl7, N7_READS, truth7, 0.75,
                                                    state=state7, **std_opt)
        launches_std = std_counts["oneshot_std"]
        if launches_std <= 0 or launches_std != std_counts["oneshot"]:
            fail(f"--dtw-std launched the std one-shot instance {launches_std} times of "
                 f"{std_counts['oneshot']}")
        ch_paf, ch_core, _, ch_counts = cuda_run("--dtw-std, ref_chunk=32,000", fa7, bl7, N7_READS,
                                                 state=state7, ref_chunk=32_000, **std_opt)
        carry_launches_std = ch_counts["carry_std"]
        ok = ch_paf == std_paf and ch_counts["oneshot"] == 0 and carry_launches_std > 0
        print(f"--dtw-std PAF of all {N7_READS} reads, chunked (std carry launches "
              f"{carry_launches_std}) vs one-shot on cuda: byte_identical={ok}")
        if not ok:
            fail("--dtw-std: the chunked route's PAF differs from the one-shot route's")

        def median_ms_out(fn, reps):
            """median_ms of fn(), and the last timed call's result."""
            last = [None]

            def call():
                last[0] = fn()
            return median_ms(call, reps), last[0]

        # the std instance at the route's shape: B=512, Q=512 over phase 7's
        # whole reference, with the start lanes of one row in ten clipped:
        # the plain version timed once, every warps instance and the timed
        # launch held to its output bit for bit
        rng8 = np.random.default_rng(SEED + 8)
        qlens8 = np.full(BATCH, W7, np.int32)
        qlens8[9::10] = rng8.integers(150, W7, size=qlens8[9::10].size)
        q8, qlens8, _ = layout.make_query_batch(
            [rng8.standard_normal(int(n)).astype(np.float32) for n in qlens8], pad_q=pad_q7)
        q8, fs8 = layout.shift_queries_for_clip(q8, qlens8, W7 - 1)
        q8, fs8 = td(q8), td(fs8)
        plain_ms_std, want = once_ms(lambda: wfm.wavefront_plain(q8, ypad7, rspad7, W7 - 1, fs8, True))
        w_std = wfm.wavefront_warps(BATCH, pad_q7)
        ms_std, timed = median_ms_out(lambda: wfm.sdtw_wavefront(
            q8, ypad7, rspad7, W7 - 1, start_lanes=fs8, std=True), 5)
        for w in warps_q7 + [None]:
            got = timed if w is None else wfm.sdtw_wavefront(q8, ypad7, rspad7, W7 - 1,
                                                             start_lanes=fs8, std=True, warps=w)
            ok = bits_equal(got, want)
            max_err = max(max_err, abs_err(got, want))
            which = f"warps={w_std}, the timed launch" if w is None else \
                f"warps={w}{'*' if w == w_std else ''}"
            print(f"wavefront std=True B={BATCH} Q={pad_q7} D={D7} {which}: bitwise_equal={ok}")
            if not ok:
                fail(f"wavefront std kernel ({which}) differs from its plain version at the "
                     f"--dtw-std route's shape (B={BATCH}, Q={pad_q7}, D={D7})")
        del got, want, timed
        bound_std_ms, bound_std_by = bound(
            OPS_PER_CELL * cells7, 4 * (BATCH * pad_q7 + 2 * D7 + BATCH * D7 + BATCH), issue)
        print(f"wavefront std=True B={BATCH} Q={pad_q7} D={D7} warps={w_std}, start lanes: "
              f"{ms_std:.3f} ms per launch (median of 5), {cells7 / ms_std / 1e6:.1f} Gcell/s, bound "
              f"{bound_std_ms:.3f} ms by {bound_std_by} ({bound_std_ms / ms_std:.1%} of it), "
              f"{launches_std} launches on the --dtw-std run; std=False {ms7:.3f} ms (phase 5); "
              f"plain version {plain_ms_std:.1f} ms; card: {smi}")

        # the std carry instance at the chunked route's shape: B=512, Q=512,
        # the first 32,000-diagonal segment of phase 7's reference from a
        # fresh state, with those start lanes: each warps instance timed and
        # its timed launch held to one plain carry launch (scores, and the
        # state under carry_state_mask)
        valid7 = layout.build_column_maps(state7.offsets, R7, track_sizes=state7.track_sizes)[1]
        yps7, rps7, _, Ds7, _ = prepare_chunked_inputs(state7.ref_cat, state7.reset, valid7,
                                                       pad_q7, W7, target=32768)
        y_seg, r_seg = td(yps7[0]), td(rps7[0])
        st0 = wfm.carry_fresh_state(BATCH, pad_q7, dev)
        c_plain_ms_std, c_want = once_ms(
            lambda: wfm.wavefront_plain(q8, y_seg, r_seg, W7 - 1, fs8, True, *st0))
        masks8 = wfm.carry_state_mask(fs8, BATCH, pad_q7, dev)
        c_pick7 = wfm.carry_warps(BATCH, pad_q7)
        c_std = {}
        for w in warps_q7:
            c_std[w], out = median_ms_out(lambda: wfm.sdtw_wavefront_carry(
                q8, y_seg, r_seg, *st0, W7 - 1, fs8, True, warps=w), 5)
            ok = bits_equal(out[0], c_want[0]) and all(
                bits_equal(a[m], b[m]) for a, b, m in zip(out[1:], c_want[1:], masks8))
            carry_err = max(carry_err, abs_err(out[0], c_want[0]),
                            *(abs_err(a[m], b[m]) for a, b, m in zip(out[1:], c_want[1:], masks8)))
            print(f"carry std=True B={BATCH} Q={pad_q7} Ds={Ds7} warps={w}"
                  f"{'*' if w == c_pick7 else ''}, the timed launch: scores and masked state "
                  f"bitwise_equal={ok}")
            if not ok:
                fail(f"carry std kernel (warps={w}) differs from its plain version at the chunked "
                     f"--dtw-std route's shape (B={BATCH}, Q={pad_q7}, Ds={Ds7})")
        del out, c_want
        c_cells7 = BATCH * pad_q7 * Ds7
        c_std_bound_ms, c_std_bound_by = bound(
            OPS_PER_CELL * c_cells7,
            4 * (BATCH * pad_q7 + 2 * Ds7 + BATCH * Ds7 + 2 * (2 * BATCH * pad_q7 + 2 * pad_q7)
                 + BATCH), issue)
        c_ms_std = c_std[c_pick7]
        print(f"carry std=True B={BATCH} Q={pad_q7} Ds={Ds7}, start lanes, fresh state: "
              + ", ".join(f"warps={w}{'*' if w == c_pick7 else ''} {t:.3f} ms" for w, t in c_std.items())
              + f" (median of 5; * = carry_warps' pick); bound {c_std_bound_ms:.3f} ms by "
              f"{c_std_bound_by} ({c_std_bound_ms / c_ms_std:.1%} of it at the pick), plain version "
              f"{c_plain_ms_std:.1f} ms, {carry_launches_std} launches on the chunked --dtw-std run; "
              f"card: {smi}")
        del y_seg, r_seg, st0, yps7, rps7

        # --full-ref: every transcript's whole track, so D is about four
        # times phase 7's. Its launch (std=False, those start lanes) timed
        # at that D and held bit for bit to one plain run
        state_f, _ = core_state(fa7, bl7, full_ref=True, **RNA_OPT)
        ypf, rpf, Df = layout.prepare_wavefront_inputs(state_f.ref_cat, state_f.reset, pad_q7)
        ypf, rpf = td(ypf), td(rpf)
        plain_ms_full, want = once_ms(lambda: wfm.wavefront_plain(q8, ypf, rpf, W7 - 1, fs8))
        ms_full, got = median_ms_out(lambda: wfm.sdtw_wavefront(q8, ypf, rpf, W7 - 1,
                                                                start_lanes=fs8), 3)
        ok = bits_equal(got, want)
        max_err = max(max_err, abs_err(got, want))
        del got, want, ypf, rpf, q8, fs8
        cells_f = BATCH * pad_q7 * Df
        bound_full_ms, bound_full_by = bound(
            OPS_PER_CELL * cells_f, 4 * (BATCH * pad_q7 + 2 * Df + BATCH * Df + BATCH), issue)
        print(f"wavefront --full-ref B={BATCH} Q={pad_q7} D={Df} warps={w_std}, start lanes: "
              f"{ms_full:.3f} ms per launch (median of 3), {cells_f / ms_full / 1e6:.1f} Gcell/s, "
              f"bound {bound_full_ms:.3f} ms by {bound_full_by} ({bound_full_ms / ms_full:.1%} of "
              f"it), plain version {plain_ms_full:.1f} ms; the timed launch bitwise_equal={ok}; "
              f"card: {smi}")
        if not ok:
            fail(f"wavefront kernel differs from its plain version at the --full-ref shape "
                 f"(B={BATCH}, Q={pad_q7}, D={Df})")
        cuda_run("--full-ref", fa7, bl7, N7_READS, truth7, 0.75, state=state_f, full_ref=True,
                 **RNA_OPT)
        inv_opt = dict(rna=True, query_size=W7, prefix_size=0, invert=True)
        cuda_run("--invert -p 0", fa7, bl7, N7_READS, **inv_opt)

        work84 = os.path.join(work, "rna004")
        os.makedirs(work84)
        fa04, bl04, truth04 = make_rna_workload(work84, N7_TX, N7_READS, SEED + 7, rna004=True)
        log = io.StringIO()
        with contextlib.redirect_stderr(log):
            paf04, core04, dt04, _ = cuda_run("RNA004", fa04, bl04, N7_READS, truth04, 0.75,
                                              **RNA_OPT)
        print("\n".join(ln for ln in log.getvalue().splitlines() if "RNA004" in ln))
        if core04.pore_flag != jnn.PORE_RNA004 or "Detected RNA004 data" not in log.getvalue():
            fail("the RNA004 header was not detected")

        # card vs CPU for the RNA flags, on a small reference (the CPU's plain
        # loop runs one diagonal at a time): 20 transcripts, 64 reads, Q=512
        t0 = time.time()
        small, small4 = os.path.join(work, "small"), os.path.join(work, "small004")
        os.makedirs(small)
        os.makedirs(small4)
        fa_s, bl_s, _ = make_rna_workload(small, N8_SMALL_TX, N8_SMALL_READS, SEED + 80,
                                          tx_len=SMALL_TX_LEN)
        fa_s4, bl_s4, _ = make_rna_workload(small4, N8_SMALL_TX, N8_SMALL_READS, SEED + 80,
                                            tx_len=SMALL_TX_LEN, rna004=True)
        print(f"small RNA workloads: {N8_SMALL_READS} reads over {N8_SMALL_TX} transcripts, R9 and "
              f"RNA004, made in {time.time() - t0:.2f} s")
        ids = [f"read{i:05d}" for i in range(N8_SMALL_READS)]
        for label, fa_, bl_, kw in (
            ("--dtw-std", fa_s, bl_s, std_opt),
            ("--dtw-std, ref_chunk=4,000", fa_s, bl_s, dict(std_opt, ref_chunk=4_000)),
            ("--full-ref", fa_s, bl_s, dict(RNA_OPT, full_ref=True)),
            ("--invert -p 0", fa_s, bl_s, inv_opt),
            ("--from-end -p 0", fa_s, bl_s, dict(inv_opt, invert=False, from_end=True)),
            ("RNA004", fa_s4, bl_s4, RNA_OPT),
        ):
            out, _, _, _ = cuda_run(f"small {label}", fa_, bl_, N8_SMALL_READS, **kw)
            cpu_check(f"small {label}", fa_, bl_, ids, out, **kw)

        # the std instances bit for bit at B=512, Q=512 over the small
        # reference: every one-shot warps instance against the plain version,
        # and a carry chain of three segments against the one-shot launch
        st_s, pq_s = core_state(fa_s, bl_s, **std_opt)
        yp_s, rp_s, D_s = layout.prepare_wavefront_inputs(st_s.ref_cat, st_s.reset, pq_s)
        yp_s, rp_s = td(yp_s), td(rp_s)
        q8, ql8, _ = layout.make_query_batch(
            [rng8.standard_normal(int(n)).astype(np.float32) for n in qlens8], pad_q=pq_s)
        q8, fs8 = (td(a) for a in layout.shift_queries_for_clip(q8, ql8, W7 - 1))
        got_std, err = check_warps("std, Q=512 small reference", q8, fs8, True, yp_s, rp_s, W7 - 1)
        max_err = max(max_err, err)
        carry_err = max(carry_err, check_carry("std, Q=512 small reference", q8, fs8, True, got_std,
                                               [0, D_s // 3, 2 * D_s // 3 + 7, D_s], yp_s, rp_s,
                                               W7 - 1))
        del got_std, q8, fs8, yp_s, rp_s


        # ------------------------------------------------------------ 9
        phase("9 host stages on the device")
        from sigfish_tpu_torch.io.blow5 import Slow5File
        from sigfish_tpu_torch.ops import events_device as evm
        from sigfish_tpu_torch.ops import jnn_device as jdm
        from sigfish_tpu_torch.ops.events import get_events
        from sigfish_tpu_torch.runtime import pipeline as pl

        f64_issue = issue * F64_PER_F32_ISSUE
        clk_hz = clk_max * 1e6

        def same_bytes(a, b) -> bool:
            a, b = a.contiguous().cpu(), b.contiguous().cpu()
            return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
                a.view(torch.uint8), b.view(torch.uint8))

        def ev_check(label, args, rna, E):
            """The events kernel bit for bit against its plain version on
            the same card tensors, whole and stage by stage (each stage
            given the plain version's inputs); (kernel result, plain ms,
            the plain stages' outputs)."""
            prm = evm.RNA_PARAMS if rna else evm.DNA_PARAMS
            sig_t, ns_t, ru_t, of_t = args

            def plain():
                A, Q = evm.prefix_sums_plain(evm.pa_plain(sig_t, ru_t, of_t), ns_t)
                t1 = evm.tstat_plain(A, Q, ns_t, prm["window_length1"])
                t2 = evm.tstat_plain(A, Q, ns_t, prm["window_length2"])
                pk, cn, ov = evm.detector_plain(t1, t2, ns_t, prm, E)
                return evm.Peaks(A, Q, pk, cn, ov, *evm._gather(A, Q, pk, ns_t)), t1, t2

            got = evm.detect_peaks(*args, rna, E)
            plain_ms, (want, t1, t2) = once_ms(plain)
            bad = [f for f, g, w in zip(evm.Peaks._fields, got, want) if not same_bytes(g, w)]
            stages = {
                "prefix": (evm.prefix_stage(*args), (want.A, want.Q, want.end_sum, want.end_sumsq)),
                "tstat": (evm.tstat_stage(want.A, want.Q, ns_t, rna), (t1, t2)),
                "detector": (evm.detector_stage(t1, t2, ns_t, rna, E),
                             (want.peaks, want.counts, want.overflow)),
                "gather": (evm.gather_stage(want.A, want.Q, want.peaks, want.counts, ns_t),
                           (want.psum, want.psumsq)),
            }
            bad_st = [k for k, (g, w) in stages.items()
                      if not all(same_bytes(x, y) for x, y in zip(g, w))]
            print(f"events kernel vs plain, {label}: bitwise_equal={not bad}, each stage "
                  f"(prefix, tstat, detector, gather) bitwise_equal={not bad_st} "
                  f"({int(got.overflow.sum())} of {args[0].shape[1]} rows overflow E={E}; plain "
                  f"{plain_ms:.1f} ms)")
            if bad or bad_st:
                fail(f"the events kernel differs from its plain version ({label}): {bad} {bad_st}")
            return got, plain_ms, (want, t1, t2)

        def pa_check(label, args, pore):
            got = jdm.polya_end(*args, pore)
            plain_ms, want = once_ms(lambda: jdm.polya_end_plain(*args, pore))
            ok = same_bytes(got, want)
            print(f"polya_end kernel vs plain, {label}: bitwise_equal={ok} "
                  f"({int((got >= 0).sum())} ends found, {int((got < 0).sum())} -1; plain "
                  f"{plain_ms:.1f} ms)")
            if not ok:
                fail(f"the polya_end kernel differs from its plain version ({label})")
            return got, plain_ms

        for rna in (False, True):
            wn = "RNA" if rna else "DNA"
            args = evm.batch_tensors(*host_stage_batch(SEED + 9, rna), dev)
            ev_check(f"64-read fuzz batch (S=8,192), {wn} windows", args, rna,
                     evm.event_cap(args[0].shape[0]))
            edges = edge_event_batch(SEED + 9, rna)
            for rows in (37, 32):
                args = evm.batch_tensors(*(a[:rows] for a in edges), dev)
                ev_check(f"ragged-edge batch (S=1,000, B={rows}), {wn} windows", args, rna,
                         evm.event_cap(args[0].shape[0]))
        args = evm.batch_tensors(*host_stage_batch(SEED + 9, True), dev)
        edges = edge_polya_batch(SEED + 9)
        for pore, pname in ((jnn.PORE_R9, "R9"), (jnn.PORE_RNA004, "RNA004")):
            pa_check(f"64-read fuzz batch (S=8,192), {pname}", args, pore)
            for rows in (37, 32):
                pa_check(f"ragged-edge batch (S=8,292, B={rows}), {pname}",
                         evm.batch_tensors(*(a[:rows] for a in edges), dev), pore)

        def against_host(label, bl_, rna, pore):
            """Every read's device event table, through the pipeline's
            buckets, against the host eventizer (get_events) bit for bit,
            and with RNA -p -1 its device polyA end against the host scan's
            (a difference is printed, not failed: the device follows the C
            reference's f32 band, the host its f64 one). Returns the largest
            bucket: (card tensors, E, nsamples)."""
            n_reads = n_over = 0
            bad, py_diff, big = [], [], None
            t0 = time.time()
            with Slow5File(bl_) as sf:
                while True:
                    blobs = sf.read_batch(BATCH, 1 << 40)
                    if not blobs:
                        break
                    works = [pl.ReadWork(rec=sf.decode_record(b)) for b in blobs]
                    idx = [i for i, w in enumerate(works) if w.rec.len_raw_signal > 0]
                    for chunk, sig, ns, dg, of, rg in pl.event_buckets(works, idx):
                        a = evm.batch_tensors(sig, ns, dg, of, rg, dev)
                        E = evm.event_cap(sig.shape[1])
                        tables, _ = evm.assemble_events(evm.detect_peaks(*a, rna, E), ns)
                        pys = evm.to_host(jdm.polya_end(*a, pore)) if pore is not None else None
                        if big is None or sig.size > big[0][0].numel():
                            big = (a, E, ns)
                        for r, i in enumerate(chunk):
                            rec = works[i].rec
                            n_reads += 1
                            pa = rec.to_pa()
                            if pys is not None:
                                hp = jnn.detect_polya_end(rec.raw_signal, pa, pore=pore)
                                if hp != int(pys[r]):
                                    py_diff.append((rec.read_id, int(pys[r]), hp))
                            if tables[r] is None:
                                n_over += 1
                                continue
                            ref = get_events(pa, rna=rna)
                            if not all(np.array_equal(getattr(tables[r], f), getattr(ref, f))
                                       for f in ("start", "length", "mean", "stdv")):
                                bad.append(rec.read_id)
            print(f"{label}: {n_reads} reads, device event tables vs the host eventizer "
                  f"bitwise_equal={not bad} ({len(bad)} differ, {n_over} overflow the cap and "
                  f"take the host path)" + ("" if pore is None else
                  f"; polyA ends equal to the host scan's for {n_reads - len(py_diff)} of "
                  f"{n_reads}") + f" ({time.time() - t0:.1f} s)")
            for rid, d, h in py_diff:
                print(f"  polyA end of {rid}: device {d}, host scan {h}")
            if bad:
                fail(f"{label}: device event tables differ from the host's for {bad[:5]}")
            return big

        big4 = against_host("phase 4's reads", bl, False, None)
        big7 = against_host("phase 7's reads", bl7, True, jnn.PORE_R9)

        def bucket_times(label, big, rna, pore=None):
            """The kernel's ms a launch at a bucket (median of 5), held bit
            for bit to one plain run, beside its bound and chain floor; for
            events also each stage's ms alone (median of 5, on the plain
            run's inputs) and its cycles a step."""
            a, E, ns = big
            Sb, Bb = a[0].shape
            n_tot, n_max = int(ns.sum()), int(ns.max())
            extra = {}
            if pore is None:
                got, plain_ms, (want, t1, t2) = ev_check(label, a, rna, E)
                ms = median_ms(lambda: evm.detect_peaks(*a, rna, E), 5)
                k_tot = int(got.counts.sum())
                nbytes = 2 * n_tot + 16 * (n_tot + Bb) + 20 * k_tot + 37 * Bb
                t_ops = n_tot * (EVENTS_F32_OPS / issue + EVENTS_F64_OPS / f64_issue)
                steps = Sb + n_max
                floor_cyc = Sb * LAT_F64_ADD + n_max * 2 * LAT_F32
                ns_t = a[1]
                extra = dict(
                    ms_prefix=median_ms(lambda: evm.prefix_stage(*a), 5),
                    ms_tstat=median_ms(lambda: evm.tstat_stage(want.A, want.Q, ns_t, rna), 5),
                    ms_detector=median_ms(lambda: evm.detector_stage(t1, t2, ns_t, rna, E), 5),
                    ms_gather=median_ms(lambda: evm.gather_stage(
                        want.A, want.Q, want.peaks, want.counts, ns_t), 5))
                extra["cycles_per_step_prefix"] = extra["ms_prefix"] * 1e-3 * clk_hz / Sb
                extra["cycles_per_step_detector"] = extra["ms_detector"] * 1e-3 * clk_hz / n_max
                del got, want, t1, t2
            else:
                _, plain_ms = pa_check(label, a, pore)
                ms = median_ms(lambda: jdm.polya_end(*a, pore), 5)
                nbytes = 2 * n_tot + 16 * Bb
                t_ops = n_tot * POLYA_OPS / issue
                steps = 4 * n_max
                floor_cyc = steps * 2 * LAT_F32
            t_bytes = nbytes / PEAK_BYTES
            bms, by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
            floor_ms = floor_cyc / clk_hz * 1e3
            cyc = ms * 1e-3 * clk_hz / steps
            print(f"{label}: {ms:.3f} ms a launch (Sb={Sb}, Bb={Bb}, longest read {n_max}); bound "
                  f"{bms:.4f} ms by {by} ({100 * bms / ms:.2f}%); chain floor {floor_ms:.3f} ms "
                  f"({floor_cyc / steps:.1f} cycles a step assumed, {cyc:.1f} measured over "
                  f"{steps} steps); plain {plain_ms:.1f} ms; card: {smi}")
            if extra:
                print(f"  stages alone: prefix {extra['ms_prefix']:.3f} ms "
                      f"({extra['cycles_per_step_prefix']:.1f} cycles a step over {Sb}), t-stat "
                      f"{extra['ms_tstat']:.3f} ms, detector {extra['ms_detector']:.3f} ms "
                      f"({extra['cycles_per_step_detector']:.1f} cycles a step over {n_max}), "
                      f"gather {extra['ms_gather']:.3f} ms; card: {smi}")
            return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, floor_ms=floor_ms,
                        cycles_per_step=cyc, Sb=Sb, Bb=Bb, **extra)

        t4 = bucket_times("events at phase 4's largest bucket", big4, False)
        t7 = bucket_times("events at phase 7's largest bucket", big7, True)
        p7 = bucket_times("polya_end at phase 7's largest bucket", big7, True, jnn.PORE_R9)
        del big4, big7, args
        ptx_ev, ptx_pa = ptxas_table(reports["events"]), ptxas_table(reports["polya"])
        # the dynamic shared memory each entry asks for at launch
        dyn = {"detector_kernel": evm.detector_smem_bytes(), "polya_kernel": jdm.ring_bytes()}
        for table in (ptx_ev, ptx_pa):
            for r in table:
                r["dynamic_smem"] = dyn.get(r["entry"], 0)
                print(f"  ptxas {r['entry']}: {r['registers']} registers, {r['smem']} bytes static "
                      f"shared memory, {r['dynamic_smem']} dynamic, {r['spill_stores']} bytes "
                      f"spill stores, {r['spill_loads']} bytes spill loads")

        def device_run(label, fa_, bl_, host_paf, host_dt, need_polya, **kw):
            """run_dtw with --host-stages device on the card, its whole PAF
            against the host mode's of the same phase in this call."""
            evm.detect_peaks.launches = 0
            jdm.polya_end.launches = 0
            reset_counts()
            out, c9, dt9 = run_port(fa_, bl_, "cuda", host_stages="device", **kw)
            n_ev, n_pa = evm.detect_peaks.launches, jdm.polya_end.launches
            side = c9.span_seconds("host_stages")
            ok = out == host_paf
            print(f"{label} with --host-stages device on cuda: {c9.total_reads} reads, {dt9:.3f} s, "
                  f"{c9.total_reads / dt9:.1f} reads/s end to end beside {c9.total_reads / host_dt:.1f} "
                  f"in host mode ({host_dt:.3f} s, this call); events launches {n_ev}, polya_end "
                  f"launches {n_pa}; reads sent to the host path {c9.host_event_reads}; host "
                  f"stages' device time on the side stream {side:.3f} s, the main thread's wait "
                  f"for their results {c9.stage_wait:.3f} s: {c9.stage_sync:.3f} s for the side "
                  f"stream, {c9.stage_wait - c9.stage_sync:.3f} s in assemble_events and the "
                  f"copies; whole PAF byte_identical to host mode={ok}; card: {smi}")
            if not ok:
                fail(f"{label}: the device host stages' PAF differs from the host mode's")
            if n_ev <= 0 or (need_polya and n_pa <= 0):
                fail(f"{label}: the run launched no events kernel or, with -p -1, no polya_end")
            return c9, n_ev, n_pa

        _, launches_ev4, _ = device_run("phase 4", fa, bl, paf, dt, False, state=state)
        _, launches_ev7, launches_pa7 = device_run("phase 7", fa7, bl7, paf7, dt7, True,
                                                   state=state7, **RNA_OPT)
        device_run("RNA004", fa04, bl04, paf04, dt04, True, **RNA_OPT)
        # the overlap: phase 6's batches spend ~1 s each in the chunked
        # sDTW; the side stream's results must not wait behind it
        c6, _, _ = device_run("phase 6", fa6, bl6, paf6, dt6, False, state=state6)
        n_b6 = len(c6.spans["host_stages"])
        print(f"overlap on phase 6: the main thread waited {1e3 * c6.stage_wait / n_b6:.1f} ms a "
              f"bucket for {1e3 * c6.span_seconds("host_stages") / n_b6:.1f} ms of side-stream device time "
              f"({n_b6} buckets), beside {1e3 * fold_s / n_fold:.1f} ms of chunked sDTW a batch "
              f"(phase 6's --profile-cpu run); card: {smi}")
        ppaf9, pcore9, pdt9 = run_port(fa7, bl7, "cuda", state=state7, profile=True,
                                       host_stages="device", **RNA_OPT)
        print(f"phase 7 --profile-cpu with --host-stages device ({pdt9:.3f} s, unoverlapped): parse "
              f"{pcore9.parse_time:.3f} s, events and polyA (device, create_events on the host) "
              f"{pcore9.event_time:.3f} s, of which {pcore9.span_seconds("host_stages"):.3f} s on the side "
              f"stream; the main thread waited {pcore9.stage_wait:.3f} s: "
              f"{pcore9.stage_sync:.3f} s for the side stream, "
              f"{pcore9.stage_wait - pcore9.stage_sync:.3f} s in assemble_events and the copies; "
              f"normalise {pcore9.normalise_time:.3f} s, device + backtrack + PAF "
              f"{pcore9.dtw_time:.3f} s; host mode (phase 7): events {pcore7.event_time:.3f} s, "
              f"normalise with the polyA scan {pcore7.normalise_time:.3f} s; card: {smi}")
        if ppaf9 != paf7:
            fail("phase 7's --profile-cpu run with --host-stages device differs from host mode")

        # ----------------------------------------------------------- 10
        phase("10 mesh")

        def mesh_run(label, fa_, bl_, want, mesh, mode, state_, profile=False, **kw):
            """run_dtw over a --mesh grid of the card listed DP*TP times (a
            stream per shard), its whole PAF against the single-device PAF
            `want` of this call; the launch counts checked against the
            layout, no plain sweep, reads/s, peak memory and, with
            --profile-cpu, the mesh route's device seconds (CUDA events)."""
            n_dp, n_tp = (int(x) for x in mesh.split("x"))
            reset_counts()
            apm.alu_peak.launches = 0
            plain0 = wfm.wavefront_plain.calls
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # what earlier phases still hold
            out, c, dt_ = run_port(fa_, bl_, "cuda", state=state_, profile=profile, mesh=mesh,
                                   mesh_devices=["cuda:0"] * (n_dp * n_tp), **kw)
            peak = (torch.cuda.max_memory_allocated() - held) / 1e9
            route = "mesh_tracks" if mode == "tracks" else "ring"
            # the ring's clipped sub-batch: one chunked chain a batch, a
            # carry launch a segment of the single-device layout
            segs = [v[0].shape[0] for v in c._wf_chunk_cache.values()]
            clip = c.routes["chunked"] * (segs[0] if len(segs) == 1 else 0)
            n = dict(oneshot=wfm.sdtw_wavefront.launches, carry=wfm.sdtw_wavefront_carry.launches,
                     ring=wfm.sdtw_wavefront_carry.launches - clip, clip=clip,
                     alu_peak=apm.alu_peak.launches, plain=wfm.wavefront_plain.calls - plain0)
            dev_s = c.span_seconds(route) if profile else None
            dev_txt = f"{dev_s:.3f} s" if profile else "not measured (overlapped run)"
            ok = out == want
            print(f"{label}, --mesh {mesh} ({c.mesh_mode} mode{', --profile-cpu' if profile else ''}) "
                  f"on {n_dp * n_tp} x cuda:0: {c.total_reads} reads, {dt_:.3f} s, "
                  f"{c.total_reads / dt_:.1f} reads/s end to end; {route} device time {dev_txt}; "
                  f"peak device memory {peak:.3f} GB above the {held / 1e9:.3f} GB held before; "
                  f"one-shot launches {n['oneshot']}, carry launches {n['carry']} (the ring's "
                  f"{n['ring']}), ALU probe launches {n['alu_peak']}, plain sweeps {n['plain']}; "
                  f"routes {c.routes}; whole PAF byte_identical to the single-device run={ok}; "
                  f"card: {smi}")
            if not ok:
                fail(f"{label}: the --mesh {mesh} PAF differs from the single-device PAF")
            if c.mesh_mode != mode or c.routes[route] <= 0:
                fail(f"{label}: --mesh {mesh} ran in {c.mesh_mode} mode, routes {c.routes}; want {mode}")
            if n["plain"]:
                fail(f"{label}: {n['plain']} plain sweeps ran during the card run")
            if mode == "tracks" and (n["oneshot"] != c.routes[route] * n_dp * n_tp or n["carry"]):
                fail(f"{label}: {n['oneshot']} one-shot launches over {c.routes[route]} batches; want "
                     f"batches x DP x TP and no carry launch")
            return out, c, dt_, n, peak, dev_s

        def clip_batch(seed, B, Q, W_):
            """B reads of Q samples, one in ten clipped as phase 6's batches
            have them (qlen 150 .. W-1), shifted for the clip: (queries,
            start lanes) on the card."""
            rng10 = np.random.default_rng(seed)
            ql = np.full(B, W_, np.int32)
            ql[9::10] = rng10.integers(150, W_, size=ql[9::10].size)
            qb_, ql, _ = layout.make_query_batch(
                [rng10.standard_normal(int(x)).astype(np.float32) for x in ql], pad_q=Q)
            qb_, sl_ = layout.shift_queries_for_clip(qb_, ql, W_ - 1)
            return torch.from_numpy(qb_).to(dev), torch.from_numpy(sl_).to(dev)

        def hold_plain(label, got, want, masks=()):
            """A timed launch's output against the plain version's on the
            same inputs, bit for bit (a carry's state under its mask):
            fails on a difference, returns the largest error."""
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            ok, err = bits_equal(got[0], want[0]), abs_err(got[0], want[0])
            for a, b, m in zip(got[1:], want[1:], masks):
                ok = ok and bits_equal(a[m], b[m])
                err = max(err, abs_err(a[m], b[m]))
            print(f"{label}: bitwise_equal to its plain version={ok}, max_abs_err={err}")
            if not ok:
                fail(f"{label} differs from its plain version")
            return err

        def shard_oneshot(label, core, Q, W_, seed):
            """One shard's one-shot launch at its run's shape (B / DP rows,
            clipped ones from their start lanes, over shard 0's padded
            tracks) timed, and held to the plain version: (ms, error)."""
            yp_, rp_ = core._mesh_bufs[0][0][:2]
            q_, sl_ = clip_batch(seed, BATCH // 2, Q, W_)
            ms_, got = median_ms_out(lambda: wfm.sdtw_wavefront(q_, yp_, rp_, W_ - 1,
                                                                start_lanes=sl_), 3)
            want = wfm.wavefront_plain(q_, yp_, rp_, W_ - 1, sl_)
            err = hold_plain(f"one shard's one-shot launch at {label}: ({BATCH // 2}, {Q}) "
                             f"over D={yp_.shape[1]}", got, want)
            print(f"  {ms_:.3f} ms (Rs={core.shard_Rs}, {int((sl_ > 0).sum())} rows from start "
                  f"lanes); card: {smi}")
            return ms_, err

        # tracks mode, DNA: phase 4's workload (2 tracks) under 2x1
        _, c10d, dt10d, n10d, peak10d, _ = mesh_run("phase 4", fa, bl, paf, MESH_DNA, "tracks", state)
        _, _, _, _, _, dev10d = mesh_run("phase 4", fa, bl, paf, MESH_DNA, "tracks", state,
                                         profile=True)
        b10d = c10d.routes["mesh_tracks"]
        if b10d != -(-N_READS // BATCH):
            fail(f"phase 4 --mesh {MESH_DNA}: {b10d} tracks batches; want {-(-N_READS // BATCH)}")
        ms10d, err10d = shard_oneshot(f"--mesh {MESH_DNA}", c10d, pad_q, W, SEED + 10)

        # tracks mode, RNA at full width: phase 7's workload under 2x2, with
        # the host stages on the host and on the card
        _, c10r, dt10r, n10r, peak10r, _ = mesh_run("phase 7", fa7, bl7, paf7, MESH_RNA, "tracks",
                                                    state7, **RNA_OPT)
        _, _, _, _, _, dev10r = mesh_run("phase 7", fa7, bl7, paf7, MESH_RNA, "tracks", state7,
                                         profile=True, **RNA_OPT)
        evm.detect_peaks.launches = 0
        jdm.polya_end.launches = 0
        _, c10h, dt10h, n10h, peak10h, _ = mesh_run("phase 7 --host-stages device", fa7, bl7, paf7,
                                                    MESH_RNA, "tracks", state7,
                                                    host_stages="device", **RNA_OPT)
        ev10, pa10 = evm.detect_peaks.launches, jdm.polya_end.launches
        if ev10 <= 0 or pa10 <= 0:
            fail("the --mesh run with --host-stages device launched no events or polya_end kernel")
        _, _, _, _, _, dev10h = mesh_run("phase 7 --host-stages device", fa7, bl7, paf7, MESH_RNA,
                                         "tracks", state7, profile=True, host_stages="device",
                                         **RNA_OPT)
        ms10r, err10r = shard_oneshot(f"--mesh {MESH_RNA}", c10r, pad_q7, W7, SEED + 11)
        print(f"events launches {ev10}, polya_end launches {pa10} in the --mesh {MESH_RNA} "
              f"device-stages run; card: {smi}")

        # ring mode at full width: phase 6's E. coli (2 tracks < TP) over
        # its first N10_READS reads, one batch, clipped reads among them
        keep10 = [f"read{i:05d}" for i in range(N10_READS)]
        sub10 = os.path.join(work6, "ring.blow5")
        subset_blow5(bl6, sub10, set(keep10))
        want10 = "".join(by_id6[r] + "\n" for r in keep10 if r in by_id6)
        n_clip10 = sum(1 for i in range(N10_READS) if i % 10 == 9)
        _, c10g, dt10g, n10g, peak10g, dev10g = mesh_run(
            f"phase 6's first {N10_READS} reads ({n_clip10} clipped)", fa6, sub10, want10,
            MESH_RING, "ring", state6, profile=True)
        n_tp10 = int(MESH_RING.split("x")[0]) * int(MESH_RING.split("x")[1])
        b10g = c10g.routes["ring"]
        n_micro10 = 32
        want_ring = b10g * n_micro10 * n_tp10 * c10g.ring_n_sub
        print(f"ring layout: Rs={c10g.shard_Rs} columns a shard, ring_n_sub={c10g.ring_n_sub} "
              f"sub-chunks of {c10g.shard_Rs // c10g.ring_n_sub} diagonals (auto rule), "
              f"{n_micro10} microbatches; carry launches {n10g['carry']}: the clipped "
              f"sub-batch's chain {n10g['clip']} ({c10g.routes['chunked']} chunked chains x "
              f"their segments), the ring's {n10g['ring']} (want {b10g} x {n_micro10} x "
              f"{n_tp10} x {c10g.ring_n_sub} = {want_ring}); card: {smi}")
        if b10g != 1 or c10g.ring_n_sub <= 1 or n10g["ring"] != want_ring:
            fail(f"the ring run's carry launches {n10g['ring']} do not match its layout "
                 f"({b10g} batches, ring_n_sub {c10g.ring_n_sub})")
        if n10g["oneshot"] or c10g.routes["chunked"] != b10g or n10g["clip"] <= 0:
            fail(f"the ring run's clipped reads did not take one chunked sub-batch a batch "
                 f"({n10g}, routes {c10g.routes})")
        # a ring hop: shard 0's last sub-chunk from a fresh state, then
        # shard 1's first from the state it hands on (the timed launch),
        # a microbatch's rows with its start lanes; both against a plain
        # chain over the same columns
        (yps0, rps0), (yps1, rps1) = (b[:2] for b in c10g._mesh_bufs[0][:2])
        Bm10 = N10_READS // n_micro10
        q10g, sl10g = clip_batch(SEED + 12, Bm10, pad_q, W)
        fresh10 = wfm.carry_fresh_state(Bm10, pad_q, dev)
        masks10 = wfm.carry_state_mask(sl10g, Bm10, pad_q, dev)
        hop0 = wfm.sdtw_wavefront_carry(q10g, yps0[-1], rps0[-1], *fresh10, W - 1,
                                        start_lanes=sl10g)
        ms10g, hop1 = median_ms_out(lambda: wfm.sdtw_wavefront_carry(
            q10g, yps1[0], rps1[0], *hop0[1:], W - 1, start_lanes=sl10g), 3)
        want0 = wfm.wavefront_plain(q10g, yps0[-1], rps0[-1], W - 1, sl10g, False, *fresh10)
        want1 = wfm.wavefront_plain(q10g, yps1[0], rps1[0], W - 1, sl10g, False, *want0[1:])
        err10g = max(
            hold_plain(f"ring carry launch, shard 0's last sub-chunk from a fresh state: "
                       f"({Bm10}, {pad_q}) over {yps0.shape[2]} diagonals", hop0, want0, masks10),
            hold_plain(f"ring carry launch, shard 1's first sub-chunk from the state handed on: "
                       f"({Bm10}, {pad_q}) over {yps1.shape[2]} diagonals", hop1, want1, masks10))
        print(f"  {ms10g:.3f} ms ({int((sl10g > 0).sum())} rows from start lanes); x {want_ring} "
              f"launches = {ms10g * want_ring / 1e3:.3f} s serial beside the ring's {dev10g:.3f} s "
              f"of device time (shard streams overlapping); card: {smi}")
        mesh10 = {
            f"tracks_dna_{MESH_DNA}": dict(reads_s=c10d.total_reads / dt10d, device_s=dev10d,
                                           peak_gb=peak10d, oneshot=n10d["oneshot"],
                                           ms_shard_launch=ms10d, max_abs_err=err10d),
            f"tracks_rna_{MESH_RNA}": dict(reads_s=c10r.total_reads / dt10r, device_s=dev10r,
                                           peak_gb=peak10r, oneshot=n10r["oneshot"],
                                           ms_shard_launch=ms10r, max_abs_err=err10r),
            f"tracks_rna_device_stages_{MESH_RNA}": dict(
                reads_s=c10h.total_reads / dt10h, device_s=dev10h, peak_gb=peak10h,
                oneshot=n10h["oneshot"], events=ev10, polya_end=pa10, ms_shard_launch=ms10r,
                max_abs_err=err10r),
            f"ring_{MESH_RING}": dict(reads_s=c10g.total_reads / dt10g, device_s=dev10g,
                                      peak_gb=peak10g, carry_ring=n10g["ring"],
                                      carry_clip=n10g["clip"], ring_n_sub=c10g.ring_n_sub,
                                      ms_shard_launch=ms10g, max_abs_err=err10g),
        }
        print("mesh: " + json.dumps(mesh10) + f"; card: {smi}")

        # ------------------------------------------------------------ 11
        phase("11 hosts")
        from sigfish_tpu_torch import cli as tcli

        d11 = os.path.join(work, "hosts")
        os.makedirs(d11)
        hosts11 = {}

        def host_run(label, key, argv, want, n_reads, kernels, one):
            """A HOSTS-process cluster over argv: host 0's -o must be want
            byte for byte, the peers' -o must not exist, and each host
            must have launched each of kernels. one: (label, seconds) of
            the in-process single-device run over the same reads."""
            outs, texts, dt_ = run_hosts(argv, HOSTS, d11, key)
            with open(outs[0]) as fh:
                ok = fh.read() == want
            reps = [host_report(t) for t in texts]
            print(f"--hosts {HOSTS} over {label}: {dt_:.3f} s wall (processes started to all "
                  f"exited), {n_reads / dt_:.1f} reads/s; Data processing time "
                  + ", ".join(f"host {i} {r['processing_s']:.3f} s" for i, r in enumerate(reps))
                  + f" ({one[0]}: {one[1]:.3f} s, {n_reads / one[1]:.1f} reads/s); launches by "
                  f"host {[r['launches'] for r in reps]}; host 0's output byte_identical={ok}; "
                  f"card: {smi}")
            if not ok:
                fail(f"the --hosts {HOSTS} run over {label} differs from the single-device PAF")
            if any(os.path.exists(o) for o in outs[1:]):
                fail(f"a peer of the --hosts {HOSTS} run over {label} opened its -o")
            for i, r in enumerate(reps):
                for k in kernels:
                    if r["launches"].get(k, 0) <= 0:
                        fail(f"host {i} of the --hosts {HOSTS} run over {label} launched no {k} "
                             f"kernel ({r['launches']})")
            hosts11[key] = dict(wall_s=dt_, reads_s=n_reads / dt_,
                                processing_s=[r["processing_s"] for r in reps],
                                launches=[r["launches"] for r in reps])
            return texts

        texts11 = host_run("phase 4's workload", "dna", dtw_argv(fa, bl), paf, N_READS,
                           ("sdtw_wavefront",), ("phase 4's in-process run", dt4))
        all_line = next((ln for ln in texts11[0].splitlines() if f"(all {HOSTS} hosts)" in ln), "")
        print(f"host 0: {all_line.strip()}; phase 4: {counts4!r}")
        if not all_line.endswith(counts4):
            fail(f"the --hosts {HOSTS} run's counters differ from phase 4's")
        host_run("phase 7's workload, --host-stages device", "rna_device_stages",
                 [*dtw_argv(fa7, bl7, rna=True), "--host-stages", "device"], paf7, N7_READS,
                 ("sdtw_wavefront", "events", "polya_end"),
                 ("phase 7's in-process run, host stages on the host", dt7))

        # --shard I/2: two processes side by side, no cluster
        souts = [os.path.join(d11, f"shard{i}.out") for i in range(HOSTS)]
        rcs, texts, dt11s = run_procs([[*dtw_argv(fa, bl), "--shard", f"{i}/{HOSTS}", "-o", souts[i]]
                                       for i in range(HOSTS)], d11, "shard")
        if any(rcs):
            fail(f"a --shard run exited {rcs}:\n" + "\n---\n".join(t[-2000:] for t in texts))
        ok = True
        for i, so in enumerate(souts):
            with open(so) as fh:
                ok = ok and fh.read() == stripe(paf, i, HOSTS)
        reps = [host_report(t) for t in texts]
        print(f"--shard I/{HOSTS} over phase 4's workload, both stripes side by side: "
              f"{dt11s:.3f} s wall, {N_READS / dt11s:.1f} reads/s; Data processing time "
              + ", ".join(f"stripe {i} {r['processing_s']:.3f} s" for i, r in enumerate(reps))
              + f"; each stripe the phase-4 lines of its records (index = I mod {HOSTS}), "
              f"in file order: {ok}; card: {smi}")
        if not ok:
            fail("a --shard stripe differs from phase 4's lines of its records")
        hosts11["shard"] = dict(wall_s=dt11s, reads_s=N_READS / dt11s,
                                processing_s=[r["processing_s"] for r in reps])

        # --trace DIR on phase 4's single-device run, in this process
        tdir, tout = os.path.join(d11, "trace"), os.path.join(d11, "traced.paf")
        reset_counts()
        t0 = time.time()
        log11 = io.StringIO()
        with contextlib.redirect_stderr(log11):
            rc = tcli.main(["dtw", *dtw_argv(fa, bl), "--trace", tdir, "-o", tout])
        dt11t = time.time() - t0
        if rc != 0:
            fail(f"the --trace run exited {rc}:\n{log11.getvalue()[-3000:]}")
        with open(tout) as fh:
            ok = fh.read() == paf
        tpath = tcli.trace_path(tdir, 0)
        with open(tpath) as fh:
            events = json.load(fh)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        wf_events = [e for e in kern if "wavefront_kernel" in e.get("name", "")]
        busy = sum(e.get("dur", 0) for e in kern) / 1e6
        span = [min(e["ts"] for e in events if "ts" in e), max(e["ts"] + e.get("dur", 0)
                                                           for e in events if "ts" in e)]
        span_s = (span[1] - span[0]) / 1e6
        print(f"--trace over phase 4's workload: {dt11t:.3f} s ({N_READS / dt11t:.1f} reads/s "
              f"under the profiler; Data processing time "
              f"{host_report(log11.getvalue())['processing_s']:.3f} s), PAF byte_identical={ok}; {tpath} holds {len(events)} events "
              f"({os.path.getsize(tpath) / 1e6:.1f} MB), {len(kern)} kernel events, "
              f"{len(wf_events)} of the wavefront kernel beside sdtw_wavefront.launches "
              f"{wfm.sdtw_wavefront.launches}; kernels busy {busy:.3f} s of the trace's "
              f"{span_s:.3f} s; card: {smi}")
        if not ok:
            fail("the --trace run's PAF differs from phase 4's")
        if not wf_events:
            fail("the trace holds no event of the wavefront kernel")
        hosts11["trace"] = dict(wall_s=dt11t, wavefront_events=len(wf_events),
                                wavefront_launches=wfm.sdtw_wavefront.launches,
                                kernel_busy_s=busy, trace_span_s=span_s)
        print("hosts: " + json.dumps(hosts11) + f"; card: {smi}")
        launches11 = {k: {run: sum(r.get(k, 0) for r in hosts11[run]["launches"])
                          for run in ("dna", "rna_device_stages")}
                      for k in ("sdtw_wavefront", "sdtw_wavefront_carry", "alu_peak", "events",
                                "polya_end")}

        # ------------------------------------------------------------ 12
        phase("12 pore-model trainer")
        import copy

        from sigfish_tpu_torch.io.fasta import read_fasta
        from sigfish_tpu_torch.models import train_model as tm
        from sigfish_tpu_torch.models.pore_model import (
            MODEL_ID_DNA_R9,
            MODEL_ID_RNA_R9,
            load_builtin_model,
        )
        from sigfish_tpu_torch.ops import train_dtw as tdm

        d12 = os.path.join(work, "train")
        os.makedirs(d12)
        dna_paf, rna_paf = os.path.join(d12, "dna.paf"), os.path.join(d12, "rna.paf")
        write_truth_paf(dna_paf, truth, {contig_of(truth): N_BASES},
                        [f"read{i:05d}" for i in range(N12_DNA_READS)])
        write_truth_paf(rna_paf, truth7, {nm: len(sq) for nm, sq in read_fasta(fa7)},
                        [f"read{i:05d}" for i in range(N12_RNA_READS)])
        t0 = time.time()
        dna_cases = tm.load_cases(bl, fa, dna_paf, rna=False, k=6)
        rna_cases = tm.load_cases_trimmed_rna(bl7, fa7, rna_paf, k=5)
        if (len(dna_cases), len(rna_cases)) != (N12_DNA_READS, N12_RNA_READS):
            fail(f"phase 12 loaded {len(dna_cases)} DNA and {len(rna_cases)} RNA cases, want "
                 f"{N12_DNA_READS} and {N12_RNA_READS}")
        # the first reads' cases as loaded, for the card-vs-CPU runs
        cases16 = [(copy.deepcopy(dna_cases[:N12_CPU_READS]), copy.deepcopy(rna_cases[:N12_CPU_READS]))
                   for _ in range(2)]
        print(f"training cases, loaded in {time.time() - t0:.2f} s: {len(dna_cases)} DNA reads "
              f"({int(np.mean([c.event_mean.size for c in dna_cases]))} events and "
              f"{int(np.mean([c.kmers.size for c in dna_cases]))} 6-mers a read on average), "
              f"{len(rna_cases)} RNA reads over {len({c.tid for c in rna_cases})} transcripts "
              f"({int(np.mean([c.event_mean.size for c in rna_cases]))} trimmed events and "
              f"{int(np.mean([c.kmers.size for c in rna_cases]))} 5-mers a read)")

        # the trainer's first call of each E-step DP (iteration 1's cases),
        # recorded as it passes them, for the kernel checks below
        first12 = {}

        def recorded(key, fn):
            def call(*a):
                first12.setdefault(key, a)
                return fn(*a)
            return call

        pairs_fns = (tdm.gap_pairs, tdm.banded_pairs)
        tdm.gap_pairs = recorded("gap", pairs_fns[0])
        tdm.banded_pairs = recorded("banded", pairs_fns[1])
        tdm.gap_sdtw.launches = tdm.banded_dtw.launches = 0
        reset_counts()
        log12 = io.StringIO()
        tim12 = {"fit_model": [], "fit_model_banded": [], "finetune": []}
        t0 = time.time()
        try:
            with contextlib.redirect_stderr(log12):
                dna_model = tm.fit_model(dna_cases, k=6, iters=ITERS12_DNA, device="cuda",
                                         timings=tim12["fit_model"])
                rna_lv = tm.fit_model_banded(rna_cases, k=5, iters=ITERS12_RNA, device="cuda",
                                             timings=tim12["fit_model_banded"])
                rna_lv = tm.finetune_inference_matched(
                    rna_lv, tm.inference_windows(rna_cases, fa7), k=5, iters=ITERS12_FINETUNE,
                    device="cuda", timings=tim12["finetune"])
        finally:
            tdm.gap_pairs, tdm.banded_pairs = pairs_fns
        dt12 = time.time() - t0
        launches12 = {"gap_sdtw": tdm.gap_sdtw.launches, "banded_dtw": tdm.banded_dtw.launches,
                      "sdtw_wavefront": wfm.sdtw_wavefront.launches}
        print("\n".join("  " + ln for ln in log12.getvalue().splitlines()))
        for stage, recs in tim12.items():
            for r in recs:
                print(f"{stage} iter {r['iter']}: {r['seconds']:.3f} s; E-step {r['estep_s']:.4f} s "
                      f"({r['estep_device_s']:.4f} s on the device, CUDA events), host "
                      f"{r['seconds'] - r['estep_s']:.3f} s, kernel launches {r['launches']}")
        print(f"trained on the card in {dt12:.1f} s; kernel launches {launches12}; card: {smi}")
        if min(launches12.values()) <= 0:
            fail(f"the trainer's E-steps missed a kernel: launches {launches12}")
        if not (np.isfinite(dna_model.level_mean).all() and np.isfinite(rna_lv).all()):
            fail("a trained table holds a value that is not finite")
        r_dna = np.corrcoef(dna_model.level_mean.astype(np.float64),
                            load_builtin_model(MODEL_ID_DNA_R9).level_mean.astype(np.float64))[0, 1]
        r_rna = np.corrcoef(rna_lv, load_builtin_model(MODEL_ID_RNA_R9).level_mean.astype(
            np.float64))[0, 1]
        print(f"Pearson r of each trained table with the shipped table its reads were drawn from "
              f"(not gated): R9 DNA 6-mer {r_dna:.4f}, R9 RNA 5-mer {r_rna:.4f}")

        # each kernel bit for bit against its plain version on the card, on
        # iteration 1's cases, and timed there: a call, its one launch alone
        # (the sweep, the end and the walk), its peak memory above what was
        # held before it, the SM cycles a step of the largest case's sweep
        # (the kernel's clocks) and that chain's floor
        from sigfish_tpu_torch.scripts.timing import (banded_case_steps, gap_case_steps,
                                                      profile_launch, timed_call)

        rows, cols, gu12, gl12, _ = first12["gap"]
        x12, n12 = tdm.pack(rows, dev)
        y12, m12 = tdm.pack(cols, dev)
        gap_ms, gap_mb = timed_call(lambda: tdm.gap_sdtw(x12, y12, n12, m12, gu12, gl12), 5)
        got = tdm.gap_sdtw(x12, y12, n12, m12, gu12, gl12)
        gap_plain_ms, want = once_ms(lambda: tdm.gap_sdtw_plain(x12, y12, n12, m12, gu12, gl12))
        ok = all(bits_equal(a, b) for a, b in zip(got, want))
        gap_err = max(abs_err(a.float(), b.float()) for a, b in zip(got, want))
        gap_cells = int(sum(r.size * c.size for r, c in zip(rows, cols)))
        gap_bound_ms, gap_bound_by = bound(
            GAP_OPS_PER_CELL * gap_cells,
            4 * sum(r.size + c.size for r, c in zip(rows, cols)) + 8 * int(got[4].sum()), issue)
        gap_R = tdm.GAP_STRIPE // 32
        gap_W = tdm.case_warps(x12.shape[0], -(-x12.shape[1] // tdm.GAP_STRIPE), dev)
        gap_steps12 = gap_case_steps(n12, m12, tdm.GAP_STRIPE)
        gap_prof = profile_launch(
            tdm._library("gap_dtw").sf_gap_dtw,
            lambda ck: tdm._gap_args(x12, y12, n12, m12, gu12, gl12, ck), gap_steps12, 5,
            "gap_sdtw")
        gap_steps = int(gap_steps12.max())
        gap_floor_ms = gap_steps * (gap_R + GAP_CHAIN_EXTRA) * LAT_F32 / (clk_max * 1e3)
        print(f"gap_sdtw at iteration 1's batch (B={x12.shape[0]}, N={x12.shape[1]}, "
              f"M={y12.shape[1]}, {gap_cells} cells, gaps {gu12:.4f}/{gl12:.4f}): {gap_ms:.4f} "
              f"ms a call, one launch (sweep, end and walk) {gap_prof['launch_ms']:.4f} ms; "
              f"{gap_R} rows a lane, {gap_W} warps a case; the largest case's sweep {gap_steps} "
              f"steps at {gap_prof['cycles_per_step_largest']:.1f} SM cycles a step, its walk "
              f"{gap_prof['walk_cycles_max']} cycles; chain floor {gap_floor_ms:.4f} ms "
              f"({gap_R + GAP_CHAIN_EXTRA} dependent f32 operations a step); peak memory "
              f"{gap_mb:.1f} MB a call; plain {gap_plain_ms:.1f} ms, bound {gap_bound_ms:.4f} ms "
              f"({gap_bound_by}); end, end cost and paths bitwise_equal={ok} max_abs_err={gap_err}; "
              f"card: {smi}")
        if not ok:
            fail("gap_sdtw's kernel differs from its plain version on iteration 1's cases")
        evs, lvls, bands, slack = first12["banded"][:4]
        ev12, nb12 = tdm.pack(evs, dev)
        lv12, mb12 = tdm.pack(lvls, dev)
        band12 = torch.tensor(bands, dtype=torch.int32, device=dev)
        banded_ms, banded_mb = timed_call(
            lambda: tdm.banded_dtw(ev12, lv12, nb12, mb12, band12, slack), 5)
        got = tdm.banded_dtw(ev12, lv12, nb12, mb12, band12, slack)
        banded_plain_ms, want = once_ms(
            lambda: tdm.banded_dtw_plain(ev12, lv12, nb12, mb12, band12, slack))
        ok = all(bits_equal(a, b) for a, b in zip(got, want))
        banded_err = max(abs_err(a.float(), b.float()) for a, b in zip(got, want))
        banded_cells = 0
        for e_, l_, b_ in zip(evs, lvls, bands):
            nn_, mm_, bw_ = e_.size, l_.size, max(b_, slack + 8)
            c_ = np.arange(1, nn_) * mm_ // nn_
            banded_cells += int((np.minimum(mm_, c_ + bw_ + 1) - np.maximum(0, c_ - bw_)).sum())
            banded_cells += min(mm_, bw_ + 1, slack)
        banded_bound_ms, banded_bound_by = bound(
            BANDED_OPS_PER_CELL * banded_cells,
            4 * sum(e_.size + l_.size + 1 for e_, l_ in zip(evs, lvls)) + 8 * int(got[4].sum()),
            issue)
        banded_steps12 = banded_case_steps(nb12, mb12, band12, slack)
        banded_W = tdm.case_warps(ev12.shape[0], -(-ev12.shape[1] // 32), dev)
        banded_prof = profile_launch(
            tdm._library("banded_dtw").sf_banded_dtw,
            lambda ck: tdm._banded_args(ev12, lv12, nb12, mb12, band12, slack, 0.5, 0.25, ck),
            banded_steps12, 5, "banded_dtw")
        banded_steps = int(banded_steps12.max())
        banded_floor_ms = banded_steps * BANDED_CHAIN_OPS * LAT_F32 / (clk_max * 1e3)
        print(f"banded_dtw at iteration 1's batch (B={ev12.shape[0]}, N={ev12.shape[1]}, "
              f"M={lv12.shape[1]}, {banded_cells} band cells, end_slack {slack}): "
              f"{banded_ms:.4f} ms a call, one launch (sweep, end and walk) "
              f"{banded_prof['launch_ms']:.4f} ms, {banded_W} warps a case; the largest case's "
              f"sweep {banded_steps} steps at {banded_prof['cycles_per_step_largest']:.1f} SM "
              f"cycles a step, its walk "
              f"{banded_prof['walk_cycles_max']} cycles; chain floor {banded_floor_ms:.4f} ms "
              f"({BANDED_CHAIN_OPS} dependent f32 operations a step); peak memory {banded_mb:.1f} "
              f"MB a call; plain {banded_plain_ms:.1f} ms, bound {banded_bound_ms:.5f} ms "
              f"({banded_bound_by}); end cells and paths bitwise_equal={ok} "
              f"max_abs_err={banded_err}; card: {smi}")
        if not ok:
            fail("banded_dtw's kernel differs from its plain version on iteration 1's cases")
        del x12, y12, ev12, lv12, got, want

        # the card's tables against the port's CPU run over the first reads
        tabs = {}
        for dv, (dc, rc) in zip(("cuda", "cpu"), cases16):
            t0 = time.time()
            with contextlib.redirect_stderr(io.StringIO()):
                t_dna = tm.fit_model(dc, k=6, iters=ITERS12_CPU, device=dv).level_mean
                lv = tm.fit_model_banded(rc, k=5, iters=ITERS12_CPU, device=dv)
                lv = tm.finetune_inference_matched(lv, tm.inference_windows(rc, fa7), k=5,
                                                   iters=ITERS12_CPU, device=dv)
            tabs[dv] = (t_dna, lv, time.time() - t0)
        ok = (np.array_equal(tabs["cuda"][0], tabs["cpu"][0])
              and np.array_equal(tabs["cuda"][1], tabs["cpu"][1]))
        print(f"tables over the first {N12_CPU_READS} reads of each at {ITERS12_CPU} iterations "
              f"(fit_model, fit_model_banded, finetune), card vs the port's CPU run: "
              f"bitwise_equal={ok} (card {tabs['cuda'][2]:.1f} s, cpu {tabs['cpu'][2]:.1f} s)")
        if not ok:
            fail("the card's trained tables differ from the CPU run's")

        # ------------------------------------------------------------ 13
        phase("13 engines")
        from sigfish_tpu_torch.ops import sdtw_scan as ssm

        t13 = time.time()

        def scan_batch(seed, B, Q, W_, every):
            """B seeded reads of Q samples, one in `every` clipped (qlen
            25 .. W-1) and the last of qlen 0: (queries, one-hot) on the
            card."""
            rng13 = np.random.default_rng(seed)
            ql = np.full(B, W_, np.int32)
            ql[every - 1 :: every] = rng13.integers(25, W_, size=ql[every - 1 :: every].size)
            ql[-1] = 0
            qb_, _, oh_ = layout.make_query_batch(
                [rng13.standard_normal(int(x)).astype(np.float32) for x in ql], pad_q=Q)
            return torch.from_numpy(qb_).to(dev), torch.from_numpy(oh_).to(dev)

        def scan_ref(st):
            return (torch.from_numpy(st.ref_cat).to(dev), torch.from_numpy(st.reset).to(dev))

        y4, r4 = scan_ref(state)
        y7, r7 = scan_ref(state7)
        # the kernel against its plain version, each mode on B=64 (one read
        # in three clipped, one of qlen 0): Q=256 over phase 4's columns
        # 20,000 .. 40,000 (the '-' track's start, a reset, inside), Q=512
        # one-shot and std over phase 7's first CUT3_DIAGS columns (a reset
        # every ~1,000), and a carry chain of three uneven segments
        q64, oh64 = scan_batch(SEED + 13, 64, pad_q, W, 3)
        q64r, oh64r = scan_batch(SEED + 14, 64, pad_q7, W7, 3)
        cut4 = (y4[20_000:40_000], r4[20_000:40_000])
        cut7 = (y7[:CUT3_DIAGS], r7[:CUT3_DIAGS])
        if not (bool(cut4[1].any()) and int(cut7[1].sum()) > 1):
            fail("phase 13's reference cuts hold no reset")
        scan_err = 0.0
        whole4 = None
        for label, q_, oh_, (y_, r_), std_ in (
            (f"one-shot Q={pad_q}", q64, oh64, cut4, False),
            (f"one-shot Q={pad_q7}", q64r, oh64r, cut7, False),
            (f"std Q={pad_q7}", q64r, oh64r, cut7, True),
        ):
            got = ssm.sdtw_scan(q_, oh_, y_, r_, std=std_)
            want = ssm.scan_plain(q_, oh_, y_, r_, std=std_)
            whole4 = got if whole4 is None else whole4
            scan_err = max(scan_err, hold_plain(
                f"the scan kernel, {label}, B=64 over {y_.shape[0]} columns ({int(r_.sum())} "
                f"resets; final column too)", got, want, masks=(slice(None),)))
        init13, parts13 = None, []
        n4c = cut4[0].shape[0]
        for a, b in ((0, 4_321), (4_321, 4_322), (4_322, n4c)):
            lr_, init13 = ssm.sdtw_scan(q64, oh64, cut4[0][a:b], cut4[1][a:b], init=init13)
            parts13.append(lr_)
        ok = bits_equal(torch.cat(parts13, 1), whole4[0]) and bits_equal(init13, whole4[1])
        print(f"the scan kernel's carry mode, three segments of 4,321, 1 and {n4c - 4_322} "
              f"columns chained: bitwise_equal to the one-shot launch={ok}")
        if not ok:
            fail("the scan kernel's chained segments differ from its one-shot launch")

        # the launch at the main path's shapes, timed and held to one plain
        # run each: B=512 over phase 4's whole reference at Q=256 and over
        # phase 7's at Q=512. The bound counts the function's operations a
        # cell; the kernel's split into runs issues RUN_OPS_PER_CELL more,
        # printed as a second bound beside it
        def scan_times(label, seed, Q, W_, y_, r_):
            q_, oh_ = scan_batch(seed, BATCH, Q, W_, 10)
            ms_, got = median_ms_out(lambda: ssm.sdtw_scan(q_, oh_, y_, r_), 3)
            plain_ms_, want = once_ms(lambda: ssm.scan_plain(q_, oh_, y_, r_))
            err = hold_plain(f"the scan kernel at {label}, B={BATCH}, Q={Q}, R={y_.shape[0]}",
                             got, want, masks=(slice(None),))
            del got, want
            R_ = y_.shape[0]
            cells = BATCH * Q * R_
            moved = 4 * BATCH * Q * 2 + 4 * BATCH + 5 * R_ + 4 * BATCH * R_
            b_ms, b_by = bound(ssm.OPS_PER_CELL * cells, moved, issue)
            bi_ms, _ = bound((ssm.OPS_PER_CELL + ssm.RUN_OPS_PER_CELL) * cells, moved, issue)
            cyc = ms_ * 1e-3 * clk_max * 1e6 / R_
            print(f"  {ms_:.3f} ms a launch ({cells / ms_ / 1e6:.1f} Gcell/s, {cyc:.1f} SM cycles a "
                  f"column at the max clock), bound {b_ms:.3f} ms by {b_by} "
                  f"({ssm.OPS_PER_CELL} operations a cell; share {b_ms / ms_:.3f}; at the "
                  f"{ssm.OPS_PER_CELL + ssm.RUN_OPS_PER_CELL} the kernel issues {bi_ms:.3f} ms), "
                  f"plain {plain_ms_:.1f} ms; card: {smi}")
            return dict(ms=ms_, plain_ms=plain_ms_, bound_ms=b_ms, bound_by=b_by, err=err,
                        bound_ms_issued=bi_ms, cycles_per_column=cyc)

        st4 = scan_times("phase 4's reference", SEED + 15, pad_q, W, y4, r4)
        st7 = scan_times("phase 7's reference", SEED + 16, pad_q7, W7, y7, r7)
        scan_err = max(scan_err, st4["err"], st7["err"])
        del y4, r4, y7, r7, q64, oh64, q64r, oh64r, cut4, cut7, whole4, parts13, init13

        def engine_run(label, fa_, bl_, want_default, truth_, gate, **kw):
            """run_dtw on the card on an engine (kw): its PAF, Core,
            seconds and launch counts (set to 0 just before), the lines
            that differ from the default engine's PAF and the share
            mapped over the reads' origins, printed."""
            reset_counts()
            ssm.sdtw_scan.launches = ssm.sdtw_scan.launches_std = 0
            plain0 = (wfm.wavefront_plain.calls, ssm.scan_plain.calls)
            out, c, dt_ = run_port(fa_, bl_, "cuda", **kw)
            n = dict(scan=ssm.sdtw_scan.launches, wavefront=wfm.sdtw_wavefront.launches,
                     carry=wfm.sdtw_wavefront_carry.launches,
                     plain=wfm.wavefront_plain.calls - plain0[0] + ssm.scan_plain.calls - plain0[1])
            a_ = {ln.split("\t")[0]: ln for ln in out.splitlines()}
            b_ = {ln.split("\t")[0]: ln for ln in want_default.splitlines()}
            diff = sum(a_.get(k) != b_.get(k) for k in set(a_) | set(b_))
            share_ = overlap_share(out, truth_)
            print(f"{label}: engine {c.engine}, {c.total_reads} reads, {dt_:.3f} s, "
                  f"{c.total_reads / dt_:.1f} reads/s end to end; launches {n}; lines differing "
                  f"from the default engine's PAF: {diff} of {len(b_)}; mapped over their origin "
                  f"{share_:.4f}; card: {smi}")
            if n["plain"]:
                fail(f"{label}: {n['plain']} plain sweeps ran during the card run")
            if share_ < gate:
                fail(f"{label}: only {share_:.4f} of the reads map over their origin")
            return out, c, dt_, n, diff

        # phase 4's workload at full width on the scan engine, and its first
        # SUBSET13 reads held byte for byte to the port's CPU scan
        paf13, c13, dt13, n13, diff13 = engine_run("phase 4, --engine scan", fa, bl, paf, truth,
                                                   0.8, state=state, engine="scan")
        launches13 = n13["scan"]
        if launches13 <= 0 or n13["wavefront"] or n13["carry"] or c13.total_reads != N_READS:
            fail(f"phase 4 on the scan engine: launches {n13}, {c13.total_reads} reads")
        keep13 = [f"read{i:05d}" for i in range(SUBSET13)]
        sub13 = os.path.join(work, "subset13.blow5")
        subset_blow5(bl, sub13, set(keep13))
        cpu13, _, cpu_dt13 = run_port(fa, sub13, "cpu", state=state, engine="scan")
        ok = cpu13 == lines_of(paf13, keep13)
        print(f"PAF of {SUBSET13} reads on the scan engine, cpu vs cuda: byte_identical={ok} "
              f"(cpu {cpu_dt13:.1f} s)")
        if not ok:
            fail("the scan engine's PAF on the card differs from the CPU path's")

        # phase 7's workload (Q=512) on the scan engine, the same way
        paf13r, c13r, dt13r, n13r, diff13r = engine_run(
            "phase 7, --engine scan", fa7, bl7, paf7, truth7, 0.75, state=state7, engine="scan",
            **RNA_OPT)
        launches13r = n13r["scan"]
        if launches13r <= 0 or n13r["wavefront"] or c13r.routes["clip_pass"] <= 0:
            fail(f"phase 7 on the scan engine: launches {n13r}, routes {c13r.routes}")
        cpu13r, _, cpu_dt13r = run_port(fa7, sub7, "cpu", state=state7, engine="scan", **RNA_OPT)
        ok = cpu13r == lines_of(paf13r, keep7)
        print(f"PAF of {SUBSET7} RNA reads on the scan engine, cpu vs cuda: byte_identical={ok} "
              f"(cpu {cpu_dt13r:.1f} s)")
        if not ok:
            fail("the RNA scan engine's PAF on the card differs from the CPU path's")

        # the native engine (exact, on the host) over phase 4's reads, and
        # --accel over phase 4
        paf13n, _, dt13n, n13n, diff13n = engine_run(
            "phase 4, --engine native", fa, bl, paf, truth, 0.8, state=state, engine="native")
        if paf13n != paf or any(n13n.values()):
            fail(f"the native engine's PAF differs from the default's ({diff13n} lines) or it "
                 f"launched a kernel: {n13n}")
        accel13 = {}
        for accel, want_, tag in ((True, paf, "default"), (False, paf13, "--engine scan")):
            out_, c_, dt_, n_, _ = engine_run(f"phase 4, --accel {'yes' if accel else 'no'}", fa,
                                              bl, paf, truth, 0.8, state=state, use_pallas=accel)
            ok = out_ == want_
            print(f"  byte_identical to the {tag} run={ok}")
            if not ok:
                fail(f"--accel {'yes' if accel else 'no'} differs from the {tag} run")
            accel13["yes" if accel else "no"] = dt_

        # the scan on the mesh over the card listed once per shard: tracks
        # mode (2x1) and ring mode (1x4, 2 tracks < 4) over phase 4
        launches13m = 0
        for mesh13, mode13 in ((MESH_DNA, "tracks"), ("1x4", "ring")):
            n_dev13 = int(np.prod([int(x) for x in mesh13.split("x")]))
            out_, c_, dt_, n_, _ = engine_run(
                f"phase 4, --engine scan --mesh {mesh13}", fa, bl, paf, truth, 0.8, state=state,
                engine="scan", mesh=mesh13, mesh_devices=["cuda:0"] * n_dev13)
            route13 = "mesh_tracks" if mode13 == "tracks" else "ring"
            ok = out_ == paf13
            print(f"  {c_.mesh_mode} mode, routes {c_.routes}, Rs={c_.shard_Rs}: byte_identical "
                  f"to the single-device scan={ok}")
            if not ok or c_.mesh_mode != mode13 or c_.routes[route13] <= 0 or n_["wavefront"]:
                fail(f"the scan on --mesh {mesh13} differs from the single-device scan or ran "
                     f"another route: {c_.mesh_mode}, {c_.routes}, {n_}")
            launches13m += n_["scan"]
        print(f"phase 4 reads/s by engine: default {N_READS / dt4:.1f}, scan {N_READS / dt13:.1f}, "
              f"native {N_READS / dt13n:.1f}, --accel yes "
              f"{N_READS / accel13['yes']:.1f}, "
              f"--accel no {N_READS / accel13['no']:.1f}; phase 7: default "
              f"{N7_READS / dt7:.1f}, scan {N7_READS / dt13r:.1f}; phase 13 took "
              f"{time.time() - t13:.1f} s; card: {smi}")

        # the carry entry times the instance phase 6 launched (every launch
        # with start lanes, checked above); the start lanes add B i32 reads
        c_bound_ms, c_bound_by = bound(OPS_PER_CELL * c_cells, c_bytes + 4 * BATCH, issue)
        result = {"kernels": [
            {
                "name": "sdtw_wavefront",
                "route": "cuda",
                "source": "sigfish_tpu_torch/csrc/wavefront.cu",
                "replaces": "sigfish_tpu/ops/sdtw_pallas.py:174",
                "launches": launches,
                "launches_hosts": launches11["sdtw_wavefront"],
                "max_abs_err": max_err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
                "warps": {str(BATCH): wfm.wavefront_warps(BATCH, pad_q), "16": w16},
                "ms_b16": ms16,
                "launches_rna": launches7,
                "launches_mesh": n10d["oneshot"] + n10r["oneshot"] + n10h["oneshot"],
                "launches_train": launches12["sdtw_wavefront"],
                "ms_q512": ms7,
                "plain_ms_q512": plain_ms7,
                "bound_ms_q512": bound7_ms,
                "bound_by_q512": bound7_by,
                "warps_q512": w7,
                "ms_by_warps_q512": {str(w): t for w, t in table7[BATCH].items()},
                "launches_std": launches_std,
                "ms_std_q512": ms_std,
                "plain_ms_std_q512": plain_ms_std,
                "bound_ms_std_q512": bound_std_ms,
                "diags_full_ref": Df,
                "ms_full_ref_q512": ms_full,
                "plain_ms_full_ref_q512": plain_ms_full,
                "bound_ms_full_ref_q512": bound_full_ms,
            },
            {
                "name": "sdtw_wavefront_carry",
                "route": "cuda",
                "source": "sigfish_tpu_torch/csrc/wavefront.cu",
                "replaces": "sigfish_tpu/ops/sdtw_pallas.py:211",
                "launches": carry_launches,
                "launches_hosts": launches11["sdtw_wavefront_carry"],
                "launches_mesh": n10g["carry"],
                "max_abs_err": carry_err,
                "ms": c_ms_sl,
                "plain_ms": plain_times[True][0],
                "bound_ms": c_bound_ms,
                "bound_by": c_bound_by,
                "library_ms": None,
                "warps": {str(BATCH): c_pick},
                "launches_by_warps": {str(w): n for w, n in carry_by_warps.items()},
                "launches_start_lanes": carry_start_lanes,
                "ms_no_start_lanes": c_ms_fs0,
                "ms_by_warps": carry_bench["table"][str(BATCH)],
                "ms_by_warps_start_lanes": carry_bench["b512_start_lanes"],
                "launches_std": carry_launches_std,
                "ms_std_q512": c_ms_std,
                "plain_ms_std_q512": c_plain_ms_std,
                "bound_ms_std_q512": c_std_bound_ms,
                "ms_std_q512_by_warps": {str(w): t for w, t in c_std.items()},
            },
            {
                "name": "alu_peak",
                "route": "cuda",
                "source": "sigfish_tpu_torch/csrc/alu_peak.cu",
                "replaces": "scripts/bench_vpu_peak.py:101",
                "launches": probe_launches,
                "launches_hosts": launches11["alu_peak"],
                "launches_mesh": n10d["alu_peak"] + n10r["alu_peak"] + n10h["alu_peak"]
                + n10g["alu_peak"],
                "max_abs_err": probe_err,
                "ms": probe_ms,
                "plain_ms": probe_plain_ms,
                "bound_ms": probe_bound_ms,
                "bound_by": probe_bound_by,
                "library_ms": None,
            },
            {
                "name": "events",
                "route": "cuda",
                "source": "sigfish_tpu_torch/csrc/events.cu",
                "replaces": "sigfish_tpu/ops/events_device.py:264",
                "launches": launches_ev4,
                "launches_hosts": launches11["events"],
                "launches_mesh": ev10,
                "max_abs_err": 0.0,
                "ms": t4["ms"],
                "plain_ms": t4["plain_ms"],
                "bound_ms": t4["bound_ms"],
                "bound_by": t4["bound_by"],
                "library_ms": None,
                "bucket": [t4["Sb"], t4["Bb"]],
                "chain_floor_ms": t4["floor_ms"],
                "cycles_per_step": t4["cycles_per_step"],
                **{k: t4[k] for k in EVENT_STAGE_KEYS},
                "launches_rna": launches_ev7,
                "ms_rna": t7["ms"],
                "plain_ms_rna": t7["plain_ms"],
                "bound_ms_rna": t7["bound_ms"],
                "bucket_rna": [t7["Sb"], t7["Bb"]],
                "chain_floor_ms_rna": t7["floor_ms"],
                "cycles_per_step_rna": t7["cycles_per_step"],
                **{f"{k}_rna": t7[k] for k in EVENT_STAGE_KEYS},
                "ptxas": ptx_ev,
            },
            {
                "name": "polya_end",
                "route": "cuda",
                "source": "sigfish_tpu_torch/csrc/polya.cu",
                "replaces": "sigfish_tpu/ops/jnn_device.py:89",
                "launches": launches_pa7,
                "launches_hosts": launches11["polya_end"],
                "launches_mesh": pa10,
                "max_abs_err": 0.0,
                "ms": p7["ms"],
                "plain_ms": p7["plain_ms"],
                "bound_ms": p7["bound_ms"],
                "bound_by": p7["bound_by"],
                "library_ms": None,
                "bucket": [p7["Sb"], p7["Bb"]],
                "chain_floor_ms": p7["floor_ms"],
                "cycles_per_step": p7["cycles_per_step"],
                "ptxas": ptx_pa,
            },
            {
                "name": "gap_sdtw",
                "route": "cuda",
                "source": "sigfish_tpu_torch/csrc/gap_dtw.cu",
                "replaces": "sigfish_tpu/models/train_model.py:168",
                "launches": launches12["gap_sdtw"],
                "max_abs_err": gap_err,
                "ms": gap_ms,
                "plain_ms": gap_plain_ms,
                "bound_ms": gap_bound_ms,
                "bound_by": gap_bound_by,
                "library_ms": None,
                "cells": gap_cells,
                "launch_ms": {"gap_kernel": gap_prof["launch_ms"]},
                "peak_mb": gap_mb,
                "rows_per_lane": gap_R,
                "warps": gap_W,
                "steps": gap_steps,
                "cycles_per_step": gap_prof["cycles_per_step_largest"],
                "walk_cycles": gap_prof["walk_cycles_max"],
                "chain_floor_ms": gap_floor_ms,
            },
            {
                "name": "banded_dtw",
                "route": "cuda",
                "source": "sigfish_tpu_torch/csrc/banded_dtw.cu",
                "replaces": "sigfish_tpu/models/train_model.py:419",
                "launches": launches12["banded_dtw"],
                "max_abs_err": banded_err,
                "ms": banded_ms,
                "plain_ms": banded_plain_ms,
                "bound_ms": banded_bound_ms,
                "bound_by": banded_bound_by,
                "library_ms": None,
                "cells": banded_cells,
                "launch_ms": {"banded_kernel": banded_prof["launch_ms"]},
                "peak_mb": banded_mb,
                "warps": banded_W,
                "steps": banded_steps,
                "cycles_per_step": banded_prof["cycles_per_step_largest"],
                "walk_cycles": banded_prof["walk_cycles_max"],
                "chain_floor_ms": banded_floor_ms,
            },
            {
                "name": "sdtw_scan",
                "route": "cuda",
                "source": "sigfish_tpu_torch/csrc/scan.cu",
                "replaces": "sigfish_tpu/ops/sdtw.py:82",
                "launches": launches13,
                "launches_rna": launches13r,
                "launches_mesh": launches13m,
                "max_abs_err": scan_err,
                "ms": st4["ms"],
                "plain_ms": st4["plain_ms"],
                "bound_ms": st4["bound_ms"],
                "bound_by": st4["bound_by"],
                "library_ms": None,
                "bound_ms_issued": st4["bound_ms_issued"],
                "cycles_per_column": st4["cycles_per_column"],
                "ms_q512": st7["ms"],
                "plain_ms_q512": st7["plain_ms"],
                "bound_ms_q512": st7["bound_ms"],
                "bound_ms_issued_q512": st7["bound_ms_issued"],
                "bound_by_q512": st7["bound_by"],
                "cycles_per_column_q512": st7["cycles_per_column"],
                "ptxas": ptxas_table(reports["scan"]),
            },
        ]}
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(f"all phases done in {time.time() - T_START:.1f} s")
    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
