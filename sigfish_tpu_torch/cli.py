"""Command-line interface: `python -m sigfish_tpu_torch.cli dtw`.

The `dtw` option table of sigfish_tpu/cli.py, restricted to what this
slice of the port serves (R9 DNA subsequence DTW, PAF out, one device),
plus --device. The flags of later slices are accepted and raise
NotImplementedError naming the ROADMAP.md item that brings them.

ref: sigfish src/main.c (dispatch), src/dtw_main.c.
"""

from __future__ import annotations

import argparse
import faulthandler
import sys

# SIGSEGV/SIGABRT backtraces (ref: sig_handler main.c:21-40)
faulthandler.enable()

from . import __version__
from .utils import cputime, log_error, peakrss, realtime, set_log_level


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
    p.add_argument("--rna", action="store_true", help="the dataset is direct RNA (not served yet)")
    p.add_argument("-b", "--prefix", "-p", dest="prefix", type=int, default=50, help="events to trim at query start [50]")
    p.add_argument("-q", "--query-size", type=int, default=250, help="number of events in query signal to align [250]")
    p.add_argument("--debug-break", type=int, default=-1, help="break after this many batches")
    p.add_argument("--dtw-std", action="store_true", help="use standard DTW instead of subsequence (not served yet)")
    p.add_argument("--invert", action="store_true", help="reverse the reference events instead of query (not served yet)")
    p.add_argument("--secondary", type=_yes_no, default=False, metavar="yes|no", help="print secondary mappings (not served yet)")
    p.add_argument("--full-ref", action="store_true", help="map to the full reference (not served yet)")
    p.add_argument("--from-end", action="store_true", help="map the end portion of the query (not served yet)")
    p.add_argument("--profile-cpu", type=_yes_no, default=False, metavar="yes|no", help="process section by section with per-stage timers")
    p.add_argument("--host-stages", choices=["host", "device"], default="host", help="where eventization runs (only host is served yet)")
    p.add_argument("--ref-chunk", type=int, default=0, metavar="INT", help="reference-axis chunking: 0 auto, -1 never (>0 not served yet) [0]")
    p.add_argument("-a", "--sam", action="store_true", help="output in SAM format (not served yet)")
    p.add_argument("--pore", choices=["r9", "r10", "rna004"], default=None, help="pore chemistry [auto] (only r9 is served yet)")
    p.add_argument("--ckpt", type=int, default=512, help="reference padding stride [512]")
    p.add_argument("--mesh", default=None, metavar="DPxTP", help="device mesh (not served yet)")
    p.add_argument("--device", default="cuda", help="torch device: cuda (the CUDA kernels) or cpu (their plain PyTorch versions) [cuda]")
    return p


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
    if args.prefix < 0 and not (args.rna or args.pore == "rna004"):
        p.error("DNA does not support auto query start detection.")
    if args.query_size < 0:
        p.error(f"Query size should larger than 0. You entered {args.query_size}")
    if args.batchsize < 1:
        p.error(f"Batch size should larger than 0. You entered {args.batchsize}")
    if args.threads < 1:
        p.error(f"Number of threads should larger than 0. You entered {args.threads}")

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
        ref_chunk=args.ref_chunk,
        device=args.device,
    )
    opt.check_slice()  # before -o is opened (and truncated)
    out_fp = sys.stdout if args.output in (None, "-") else open(args.output, "w")
    core = Core(args.genome, args.reads, opt)
    run_dtw(core, out_fp)

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
    core.close()
    if out_fp is not sys.stdout:
        out_fp.close()
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(
            "Usage: python -m sigfish_tpu_torch.cli <command> [options]\n\n"
            "command:\n"
            "         dtw          Map raw signals to a reference via subsequence DTW\n"
            "         --version    Print version\n"
        )
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd in ("--version", "-V"):
        print(f"sigfish_tpu_torch {__version__}")
        return 0
    if cmd != "dtw":
        sys.stderr.write(f"[main] Unknown command {cmd}\n")
        return 1
    try:
        return dtw_main(rest)
    except (FileNotFoundError, IsADirectoryError) as e:
        # reference style: a single ERROR line + EXIT_FAILURE
        log_error(f"{e.strerror}: {e.filename}")
        return 1
    except (ValueError, RuntimeError) as e:
        # NotImplementedError (an option of a later slice) included
        log_error(str(e))
        return 1


if __name__ == "__main__":
    sys.exit(main())
