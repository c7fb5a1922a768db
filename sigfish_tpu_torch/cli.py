"""Command-line interface: `python -m sigfish_tpu_torch.cli dtw|eval`.

The `dtw` option table of sigfish_tpu/cli.py, plus --device, and its
`eval` subcommand. Every dtw flag is served: the host stages on the host
or (--host-stages device) the events and the RNA polyA scan on the
device, on one device or over a --mesh grid of them, in one process or
over a cluster of host processes (--hosts/--host-id/--coordinator, each
mapping a contiguous record range and host 0 writing the merged output;
parallel/distributed.py) or one record stripe (--shard I/N), and
--trace DIR writes a torch.profiler trace of the run. --engine and
--accel choose the sDTW engine with the JAX package's precedence
(--engine by name, else --accel yes for pallas and no for scan):
pallas runs the wavefront kernel (csrc/wavefront.cu), scan the column
scan (csrc/scan.cu), native the exact host DP on the thread pool (with
--mesh the scan, as in the JAX package); with neither flag the port runs
the wavefront kernel. --device picks the card (the CUDA kernels) or the
CPU (their plain PyTorch versions); a kernel that fails to build or
launch on the card raises.

ref: sigfish src/main.c (dispatch), src/dtw_main.c, src/eval.c:380-445.
"""

from __future__ import annotations

import argparse
import faulthandler
import io
import os
import sys
import tempfile

# SIGSEGV/SIGABRT backtraces (ref: sig_handler main.c:21-40)
faulthandler.enable()

from . import __version__
from .utils import cputime, log_debug, log_error, peakrss, realtime, set_log_level


def _parse_num(s: str) -> int:
    """K/M/G suffix parsing. ref: mm_parse_num dtw_main.c:46-58."""
    mult = 1.0
    t = s
    if t and t[-1] in "GgMmKk":
        mult = {"g": 1e9, "m": 1e6, "k": 1e3}[t[-1].lower()]
        t = t[:-1]
    return int(float(t) * mult + 0.499)


def _yes_no(v: str) -> bool:
    if v in ("yes", "y"):
        return True
    if v in ("no", "n"):
        return False
    raise argparse.ArgumentTypeError("only accepts 'yes' or 'no'")


def make_dtw_parser(prog: str = "sigfish_tpu_torch dtw") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog,
        description="Map raw nanopore signals (BLOW5) to a reference (FASTA) via subsequence DTW.",
    )
    p.add_argument("genome", help="reference genome FASTA")
    p.add_argument("reads", help="signal file (BLOW5/SLOW5)")
    p.add_argument("-t", "--threads", type=int, default=8, help="number of processing threads [8]")
    p.add_argument("-K", "--batchsize", type=int, default=512, help="batch size (max reads loaded at once) [512]")
    p.add_argument("-B", "--max-bytes", type=_parse_num, default=20 * 1000 * 1000, metavar="FLOAT[K/M/G]", help="max bytes loaded at once [20.0M]")
    p.add_argument("-o", "--output", default=None, help="output to file [stdout]")
    p.add_argument("-v", "--verbose", type=int, default=4, help="verbosity level [4]")
    p.add_argument("--version", action="version", version=f"sigfish_tpu_torch {__version__}")
    p.add_argument("--kmer-model", default=None, help="custom nucleotide k-mer model file (nanopolish format)")
    p.add_argument("--meth-model", default=None, help=argparse.SUPPRESS)  # parsed, unused (parity)
    p.add_argument("-w", "--window", default=None, help=argparse.SUPPRESS)  # vestigial (parity, ref dtw_main.c:63)
    p.add_argument("--rna", action="store_true", help="the dataset is direct RNA")
    p.add_argument("-b", "--prefix", "-p", dest="prefix", type=int, default=50, help="events to trim at query start; -1 = autodetect (RNA) [50]")
    p.add_argument("-q", "--query-size", type=int, default=250, help="number of events in query signal to align [250]")
    p.add_argument("--debug-break", type=int, default=-1, help="break after this many batches")
    p.add_argument("--dtw-std", action="store_true", help="use standard DTW instead of subsequence (RNA only)")
    p.add_argument("--invert", action="store_true", help="reverse the reference events instead of query (RNA only)")
    p.add_argument("--secondary", type=_yes_no, default=False, metavar="yes|no", help="print secondary mappings (parsed; never printed, parity with reference)")
    p.add_argument("--full-ref", action="store_true", help="map to the full reference (RNA only)")
    p.add_argument("--from-end", action="store_true", help="map the end portion of the query")
    p.add_argument("--profile-cpu", type=_yes_no, default=False, metavar="yes|no", help="process section by section with per-stage timers")
    p.add_argument("--accel", type=_yes_no, default=None, metavar="yes|no", help="yes: the pallas engine, no: the scan engine (--engine wins) [the wavefront kernel]")
    p.add_argument("--engine", choices=["pallas", "scan", "native"], default=None, help="the sDTW engine: pallas the wavefront kernel, scan the column-scan kernel, native the exact host DP on the thread pool (with --mesh the scan) [the wavefront kernel]")
    p.add_argument("--host-stages", choices=["host", "device"], default="host", help="where eventization (and the RNA -p -1 polyA scan) runs: host, per read on the thread pool, or device, per batch on the CUDA kernels (their plain versions with --device cpu) [host]")
    p.add_argument("--ref-chunk", type=int, default=0, metavar="INT", help="reference-axis chunking: 0 auto (past 2^20 columns), -1 never, N>0 always, in segments of about N diagonals [0]")
    p.add_argument("-a", "--sam", action="store_true", help="output in SAM format")
    p.add_argument("--pore", choices=["r9", "r10", "rna004"], default=None, help="pore chemistry [auto]")
    p.add_argument("--ckpt", type=int, default=512, help="reference padding stride [512]")
    p.add_argument("--mesh", default=None, metavar="DPxTP", help="map over a DP x TP grid of devices: the first DP*TP CUDA devices (DP*TP plain-version shards with --device cpu); tracks split over TP and each batch over DP, or, with fewer tracks than TP, the reference split by columns over all DP*TP devices (ring mode)")
    p.add_argument("--trace", default=None, metavar="DIR", help="write a torch.profiler trace (Chrome JSON, host<I>.pt.trace.json) of the run to DIR")
    p.add_argument("--shard", default=None, metavar="I/N", help="map only record stripe I of N (manual multi-host data parallelism; concatenate per-host outputs)")
    p.add_argument("--hosts", type=int, default=None, metavar="N", help="number of host processes in the cluster [env SIGFISH_HOSTS or 1]")
    p.add_argument("--host-id", type=int, default=None, metavar="I", help="this process's id, 0..N-1 [env SIGFISH_HOST_ID]")
    p.add_argument("--coordinator", default=None, metavar="ADDR:PORT", help="host 0's store address (a TCPStore) [env SIGFISH_COORDINATOR]")
    p.add_argument("--device", default="cuda", help="torch device: cuda (the CUDA kernels) or cpu (their plain PyTorch versions) [cuda]")
    return p


def kernel_launches() -> dict[str, int]:
    """Each hand kernel's launch count in this process (its wrapper's
    counter)."""
    from .ops import alu_peak, events_device, jnn_device, sdtw_scan, sdtw_wavefront

    return {
        "sdtw_wavefront": sdtw_wavefront.sdtw_wavefront.launches,
        "sdtw_wavefront_carry": sdtw_wavefront.sdtw_wavefront_carry.launches,
        "alu_peak": alu_peak.alu_peak.launches,
        "events": events_device.detect_peaks.launches,
        "polya_end": jnn_device.polya_end.launches,
        "sdtw_scan": sdtw_scan.sdtw_scan.launches,
    }


def trace_path(trace_dir: str, host_id: int) -> str:
    """Where --trace DIR writes the trace of host host_id (0 without
    --hosts)."""
    return os.path.join(trace_dir, f"host{host_id}.pt.trace.json")


def run_traced(core, out_fp, trace_dir: str, host_id: int) -> None:
    """run_dtw under torch.profiler: CPU activity, and CUDA activity
    (every kernel, the ctypes-launched hand kernels included) when the
    run's device is CUDA, on every thread, so the pool's and the drain's
    sf.* spans (runtime/trace.py) are there beside the caller's; the
    Chrome trace goes to trace_path(). A trace that cannot be written
    raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .runtime.pipeline import run_dtw
    from .runtime.trace import profile_all_threads

    cuda = core.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path = trace_path(trace_dir, host_id)
    try:
        os.makedirs(trace_dir, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"--trace {trace_dir}: cannot create the directory: {e}") from e
    with profile(activities=acts, experimental_config=profile_all_threads()) as prof:
        run_dtw(core, out_fp)
        if cuda:
            torch.cuda.synchronize(core.device)
    try:
        prof.export_chrome_trace(path)
    except OSError as e:
        raise RuntimeError(f"--trace {trace_dir}: cannot write the trace: {e}") from e


def dtw_main(argv: list[str]) -> int:
    realtime0 = realtime()
    p = make_dtw_parser()
    args = p.parse_args(argv)
    set_log_level(args.verbose)

    # cross-flag validation, ref dtw_main.c:248-277
    if not args.rna and args.pore != "rna004":
        if args.dtw_std:
            p.error("DTW is only available for RNA.")
        if args.invert:
            p.error("Inversion is only available for RNA.")
        if args.full_ref:
            p.error("--full-ref is only available for RNA.")
    if args.prefix < 0:
        if not (args.rna or args.pore == "rna004"):
            p.error("DNA does not support auto query start detection.")
        if args.invert:
            p.error("Inversion is not compatible with auto query start detection.")
        if args.from_end:
            p.error("Mapping from query end is not compatible with auto query start detection.")
    if args.query_size < 0:
        p.error(f"Query size should larger than 0. You entered {args.query_size}")
    if args.batchsize < 1:
        p.error(f"Batch size should larger than 0. You entered {args.batchsize}")
    if args.threads < 1:
        p.error(f"Number of threads should larger than 0. You entered {args.threads}")

    from .output import sam_header
    from .runtime.pipeline import Core, Options, run_dtw

    opt = Options(
        batch_size=args.batchsize,
        batch_size_bytes=args.max_bytes,
        num_thread=args.threads,
        prefix_size=args.prefix,
        query_size=args.query_size,
        rna=args.rna or args.pore == "rna004",  # ref dtw_main.c:229-232
        dtw_std=args.dtw_std,
        invert=args.invert,
        secondary=args.secondary,
        full_ref=args.full_ref,
        from_end=args.from_end,
        sam=args.sam,
        pore=args.pore,
        model_file=args.kmer_model,
        debug_break=args.debug_break,
        profile=args.profile_cpu,
        ckpt=args.ckpt,
        mesh=args.mesh,
        host_stages=args.host_stages,
        engine=args.engine,
        use_pallas=args.accel,
        ref_chunk=args.ref_chunk,
        device=args.device,
    )
    opt.check_slice()  # before -o is opened (and truncated)
    if args.shard:
        i_s, n_s = args.shard.split("/")
        opt.shard_id, opt.n_shards = int(i_s), int(n_s)
        if not (0 <= opt.shard_id < opt.n_shards):
            p.error(f"--shard {args.shard}: need 0 <= I < N")

    # multi-host cluster (a TCPStore served by host 0); env fallbacks let
    # launchers set the topology without touching the arg vector
    n_hosts = args.hosts if args.hosts is not None else int(os.environ.get("SIGFISH_HOSTS", "1"))
    host_id = args.host_id if args.host_id is not None else int(
        os.environ.get("SIGFISH_HOST_ID", "0")
    )
    coordinator = args.coordinator or os.environ.get("SIGFISH_COORDINATOR")
    if n_hosts > 1:
        if opt.n_shards > 1:
            p.error("--shard (manual striping) and --hosts are exclusive")
        if not (0 <= host_id < n_hosts):
            p.error(f"--host-id {host_id}: need 0 <= I < --hosts {n_hosts}")
        if not coordinator:
            p.error("--hosts > 1 needs --coordinator ADDR:PORT (or SIGFISH_COORDINATOR)")
        from .parallel.distributed import init_distributed

        init_distributed(coordinator, n_hosts, host_id)

    # peers (host_id != 0) never write the merged output: do not open
    # (and truncate) --output on them -- all hosts are typically given
    # the same path on a shared filesystem, and a peer restarting after
    # host 0 finished must not wipe the result
    if args.output in (None, "-"):
        out_fp = sys.stdout
    elif n_hosts > 1 and host_id != 0:
        out_fp = None
    else:
        out_fp = open(args.output, "w")
    core = Core(args.genome, args.reads, opt)

    if n_hosts > 1:
        # contiguous byte-balanced record range for this host: one index
        # pass, then seek straight to the range start
        from .parallel.distributed import compute_host_ranges

        rng = compute_host_ranges(core.sf, n_hosts)[host_id]
        core.sf.seek_record(rng.file_offset, rng.rec_start)
        opt.rec_limit = rng.n_records
        # disk-backed body: a host never holds its full output in RAM
        # (it is streamed through the gather in bounded chunks)
        body_raw = tempfile.TemporaryFile("w+b")
        body_fp = io.TextIOWrapper(body_raw)
    else:
        body_fp = out_fp
        if opt.sam:
            out_fp.write(sam_header(core.ref.ref_names, core.ref.ref_lengths, __version__))

    if args.trace:
        run_traced(core, body_fp, args.trace, host_id)
    else:
        run_dtw(core, body_fp)

    if n_hosts > 1:
        # deterministic ordered emission: ranges are contiguous and in
        # file order, so host-order streaming reproduces the
        # single-process output byte-for-byte (host 0 writes)
        from .parallel.distributed import (
            gather_counters, gather_ordered_stream, shutdown_distributed)

        if host_id == 0 and opt.sam:
            out_fp.write(sam_header(core.ref.ref_names, core.ref.ref_lengths, __version__))
        body_fp.flush()
        gather_ordered_stream(body_raw, out_fp, host_id, n_hosts)
        totals = gather_counters(
            {
                "total_reads": core.total_reads,
                "prefix_fail": core.prefix_fail,
                "ignored": core.ignored,
                "too_short": core.too_short,
                "sum_bytes": core.sum_bytes,
            },
            host_id,
            n_hosts,
        )
        if host_id == 0:
            out_fp.flush()
            sys.stderr.write(
                f"[dtw_main] (all {n_hosts} hosts) total entries: "
                f"{totals['total_reads']}\tprefix fail: {totals['prefix_fail']}"
                f"\tignored: {totals['ignored']}\ttoo short: {totals['too_short']}\n"
            )
        # exit barrier: host 0's process serves the store, so it waits
        # until every peer has read its last confirmation
        shutdown_distributed()

    # final report, ref dtw_main.c:331-345 + main.c:98-99
    e = sys.stderr
    e.write(
        f"[dtw_main] total entries: {core.total_reads}\tprefix fail: {core.prefix_fail}"
        f"\tignored: {core.ignored}\ttoo short: {core.too_short}\n"
    )
    e.write(f"[dtw_main] total bytes: {core.sum_bytes/1e6:.1f} M\n")
    e.write(f"[dtw_main] Data loading time: {core.load_db_time:.3f} sec\n")
    e.write(f"[dtw_main] Data processing time: {core.process_db_time:.3f} sec\n")
    if opt.profile:
        e.write(f"[dtw_main]     - Parse time: {core.parse_time:.3f} sec\n")
        e.write(f"[dtw_main]     - Events time: {core.event_time:.3f} sec\n")
        e.write(f"[dtw_main]     - Normalise time: {core.normalise_time:.3f} sec\n")
        e.write(f"[dtw_main]     - DTW time: {core.dtw_time:.3f} sec\n")
    e.write(f"[dtw_main] Data output time: {core.output_time:.3f} sec\n")
    e.write(
        f"[main] Version: {__version__}\n[main] CMD: sigfish_tpu_torch dtw {' '.join(argv)}\n"
        f"[main] Real time: {realtime()-realtime0:.3f} sec; CPU time: {cputime():.3f} sec; "
        f"Peak RAM: {peakrss()/1024.0/1024.0/1024.0:.3f} GB\n"
    )
    log_debug("kernel launches: " + " ".join(f"{k}={v}" for k, v in kernel_launches().items()))
    log_debug("counts: " + " ".join(f"{k}={v}" for k, v in core.counts.items()))
    core.close()
    if out_fp is not None and out_fp is not sys.stdout:
        out_fp.close()
    return 0


def eval_cli(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="sigfish_tpu_torch eval")
    p.add_argument("truth", help="truth PAF (e.g. from minimap2)")
    p.add_argument("test", help="test PAF")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--secondary", type=_yes_no, default=True, metavar="yes|no", help="consider secondary mappings")
    p.add_argument("--tid-only", action="store_true", help="consider reference name and strand only")
    p.add_argument("--version", action="version", version=f"sigfish_tpu_torch {__version__}")
    args = p.parse_args(argv)
    from .eval import eval_main

    out = sys.stdout if args.output in (None, "-") else open(args.output, "w")
    eval_main(args.truth, args.test, sec=args.secondary, tid_only=args.tid_only, out=out)
    if out is not sys.stdout:
        out.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(
            "Usage: python -m sigfish_tpu_torch.cli <command> [options]\n\n"
            "command:\n"
            "         dtw          Map raw signals to a reference via subsequence DTW\n"
            "         eval         Evaluate a PAF against a truthset PAF\n"
            "         --version    Print version\n"
        )
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd in ("--version", "-V"):
        print(f"sigfish_tpu_torch {__version__}")
        return 0
    if cmd not in ("dtw", "eval"):
        sys.stderr.write(f"[main] Unknown command {cmd}\n")
        return 1
    try:
        return dtw_main(rest) if cmd == "dtw" else eval_cli(rest)
    except (FileNotFoundError, IsADirectoryError) as e:
        # reference style: a single ERROR line + EXIT_FAILURE
        log_error(f"{e.strerror}: {e.filename}")
        return 1
    except (ValueError, RuntimeError) as e:
        # a distributed gather's timeout (a dead peer) or lost host 0
        # included: the run fails with its diagnosis
        log_error(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
