"""The dtw pipeline: stream BLOW5 batches, map on the GPU, emit PAF/SAM.

The single-device subsequence path of sigfish_tpu/runtime/pipeline.py,
with its names and order kept:

  load_db       host   sequential raw-record fetch (src/sigfish.c:274)
  parse/event/
  normalise     host   per read, on a thread pool (native C++ where
                       built), ref sigfish.c:317-505. With --host-stages
                       device the events (csrc/events.cu via
                       ops/events_device.py) and, for RNA -p -1, the polyA
                       end (csrc/polya.cu via ops/jnn_device.py) of the
                       whole batch are found on the device instead, on a
                       stream of the Core's own (_event_batch_device)
  sDTW +
  candidates    DEVICE the wavefront sDTW kernel (csrc/wavefront.cu via
                       ops/sdtw_wavefront.py) over every (contig, strand)
                       track for the whole batch, then the window top-5
                       reduction (ops/candidates_dev.py) on the scores'
                       device; only (B, 10) packed values come back.
                       Past CHUNK_AUTO_COLS reference columns (or with
                       --ref-chunk N > 0) the reference streams through
                       the kernel's carry mode in segments instead
                       (ops/chunked_ref.py), clipped reads included.
                       --dtw-std runs the kernel's std instance and
                       gathers each track's corner on the device (one-shot
                       or chunked, CornerFold); only (B, ntracks) comes back
  backtrack/
  output        host   winner path recompute + PAF or SAM lines in batch
                       order

Device selection: Options.device ("cuda" by default). CUDA tensors go
through the kernel, CPU tensors (device="cpu") through its plain
PyTorch version. There is no silent fallback: Core raises when CUDA is
asked for and absent, and a kernel that fails to build or launch raises.

Engine choice: the JAX Core's three engines, by its precedence
(Options.engine by name, else Options.use_pallas, --accel: True picks
pallas, False scan). With neither set the port keeps the wavefront
kernel ("pallas"); it does not take the JAX Core's platform rule.
  pallas   the wavefront kernel, as above
  scan     the column scan (csrc/scan.cu via ops/sdtw_scan.py) over the
           whole reference for the batch, its (B, R) last row already
           by column (window_top5 and the clip pass with reindex=False),
           --dtw-std its std mode with the corner gather; never chunked,
           as in the JAX package, so the (B, R) row must fit the device
  native   the exact host DP (native/ sf_subsequence_lastrow,
           sf_std_lastrow) per read over every track on the thread pool,
           and the host window scan; only when asked for by name and
           without --mesh (with a mesh the scan engine runs the grid, the
           JAX Core's rule)

This port serves the single-device dtw surface of the JAX package with
host stages, over references of any length (one-shot or chunked): R9 and
R10 DNA, R9 and RNA004 direct RNA (--rna, or a header's experiment_type
rna; the chemistry from the header's sequencing_kit or --pore) with its
3'-end tracks, reversed queries and, with -p -1, the query start found
after the polyA tail on the host (ops/jnn.detect_polya_end); --sam,
--from-end, --secondary (parsed, never printed, as in the reference),
--dtw-std, --full-ref and --invert; and --host-stages device.

--mesh DPxTP runs the sDTW and candidate stage over a (dp, tp) grid of
devices (parallel/shard.py), as the JAX Core does: with at least TP
tracks in tracks mode (whole tracks split over tp, the batch over dp),
with fewer in ring mode (the layout split by columns over all DP*TP
devices, the carry state passed from shard to shard). Everything else,
and the ring's clipped reads, runs on the grid's first device over the
mesh's layout.

Across processes (parallel/distributed.py), run_dtw maps one record
stripe (Options.shard_id of n_shards) or a contiguous range the caller
seeked to (Options.rec_limit records from there), as the JAX run_dtw
does.
"""

from __future__ import annotations

import concurrent.futures as _fut
import contextlib
import math
import os
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import CoreState, core_state_from_numpy
from ..io.blow5 import Slow5File, Slow5Record
from ..io.fasta import read_fasta
from ..models.genref import RefSynth, gen_ref
from ..models.pore_model import (
    MODEL_ID_DNA_R10,
    MODEL_ID_DNA_R9,
    MODEL_ID_RNA_R9,
    MODEL_ID_RNA_RNA004,
    load_builtin_model,
    read_model_tsv,
)
from ..ops import jnn
from ..ops.candidates import compute_mapq, rank_candidates, window_argmin
from ..ops.candidates_dev import topk_candidates, window_top5
from ..ops.chunked_ref import (
    CHUNK_AUTO_COLS,
    DIAG_TILE,
    ClipFold,
    CornerFold,
    WindowFold,
    carry_chain,
    clip_window_bases,
    prepare_chunked_inputs,
    prepare_clip_inputs,
)
from ..ops.events import DNA_PARAMS, RNA_PARAMS, get_events, get_events_prefix
from ..ops.events_device import assemble_events, batch_tensors, detect_peaks, event_cap, to_host
from ..ops.jnn_device import polya_end
from ..ops.layout import (
    PAD,
    build_column_maps,
    make_query_batch,
    pad_tracks,
    prepare_wavefront_inputs,
    shift_queries_for_clip,
    unpack_top5,
)
from ..ops.sdtw_ref import path_to_map, subsequence_cost_seeded, subsequence_path
from ..ops.sdtw_scan import onehot_rows, sdtw_scan
from ..ops.sdtw_wavefront import sdtw_wavefront
from ..output import paf_line, sam_line
from ..parallel.shard import (
    make_mesh,
    ring_shape,
    ring_topk,
    ring_topk_scan,
    shard_streams,
    shard_tracks,
    sharded_topk,
)
from ..utils import log_info, log_verbose, log_warning
from .trace import span


@dataclass
class Options:
    """User options. ref: opt_t sigfish.h:121-139 + init_opt sigfish.c:1122-1144."""

    batch_size: int = 512
    batch_size_bytes: int = 20 * 1000 * 1000
    num_thread: int = 8
    prefix_size: int = 50
    query_size: int = 250
    rna: bool = False
    dtw_std: bool = False
    invert: bool = False
    secondary: bool = False
    full_ref: bool = False
    from_end: bool = False
    sam: bool = False
    pore: str | None = None  # None = auto
    model_file: str | None = None
    debug_break: int = -1
    profile: bool = False
    ckpt: int = 512
    mesh: str | None = None
    # the devices of the --mesh grid, first DP*TP of them, row by row (the
    # JAX package's make_mesh(devices=...)); None: the first DP*TP CUDA
    # devices with device="cuda", DP*TP times "cpu" with device="cpu"
    mesh_devices: list[str] | None = None
    host_stages: str = "host"
    # reference-axis chunking: 0 = auto (chunk once R + Q passes
    # CHUNK_AUTO_COLS columns), -1 = never chunk, N > 0 = always chunk,
    # in segments of about N diagonals
    ref_chunk: int = 0
    device: str = "cuda"
    # the JAX Core's engine choice: "pallas" (the wavefront kernel),
    # "scan" (the column scan) or "native" (the host DP); None takes
    # use_pallas (--accel: True pallas, False scan), and with that None
    # too the wavefront kernel
    engine: str | None = None
    use_pallas: bool | None = None
    shard_id: int = 0   # multi-host record stripe I of N
    n_shards: int = 1
    # multi-host contiguous record range: stop after this many records
    # (the host seeked to its range start via Slow5File.seek_record)
    rec_limit: int | None = None

    def check_slice(self) -> None:
        """Raise SystemExit for an unknown --host-stages, as the JAX
        package's Core does, or an unknown engine."""
        if self.host_stages not in ("host", "device"):
            raise SystemExit(f"unknown --host-stages {self.host_stages!r}")
        if self.engine not in (None, "pallas", "scan", "native"):
            raise SystemExit(f"unknown engine {self.engine!r}")


@dataclass
class BatchStats:
    n_rec: int = 0
    sum_bytes: int = 0
    prefix_fail: int = 0
    ignored: int = 0
    too_short: int = 0


def _ref_meta(fasta_path: str, state: CoreState) -> RefSynth:
    """Contig names and lengths for output, from the FASTA, with the
    event-track lengths and start offsets taken from a given state."""
    ref = RefSynth()
    for name, seq in read_fasta(fasta_path):
        ref.ref_names.append(name)
        ref.ref_seq_lengths.append(len(seq))
        ref.num_ref += 1
    if state.ref_st_offset is None:
        ref.ref_st_offset = [0] * ref.num_ref
    elif len(state.ref_st_offset) == ref.num_ref:
        ref.ref_st_offset = list(state.ref_st_offset)
    else:
        raise ValueError(
            f"state has {len(state.ref_st_offset)} contig offsets; {fasta_path} has {ref.num_ref}"
        )
    ref.ref_lengths = [0] * ref.num_ref
    for (rid, strand), size in zip(state.track_meta, state.track_sizes):
        if rid >= ref.num_ref:
            raise ValueError(f"state names contig {rid}; {fasta_path} has {ref.num_ref}")
        if strand == "+":
            ref.ref_lengths[rid] = size
    return ref


class Core:
    """Static state. ref: core_t sigfish.h:202-244 + init_core sigfish.c:81-207.

    state: a CoreState (convert.core_state_from_numpy) to use in place of
    building the pore model and the reference layout from the FASTA."""

    # max device batch rows per kernel launch; larger -K loads are split
    # into sub-launches
    DEVICE_CHUNK = 512

    def __init__(
        self, fasta_path: str, slow5_path: str, opt: Options,
        state: CoreState | None = None,
    ):
        with span("sf.setup"):
            self._setup(fasta_path, slow5_path, opt, state)

    def _setup(self, fasta_path: str, slow5_path: str, opt: Options, state: CoreState | None):
        self.opt = opt
        opt.check_slice()
        # the JAX Core's precedence, with the wavefront kernel where it
        # would ask the platform
        self.engine = opt.engine or ("scan" if opt.use_pallas is False else "pallas")
        # the wavefront kernel's routes; False: the scan's (the native
        # engine's too on a mesh, and for nothing else)
        self.use_pallas = self.engine == "pallas"
        self.device = torch.device(opt.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {opt.device!r} asked for, but torch finds no CUDA "
                "device; pass device='cpu' (--device cpu) to run the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {opt.device!r}")
        self.sf = Slow5File(slow5_path)

        # --- auto-detection from the SLOW5 header
        # ref: drna_detect / pore_detect sigfish.c:27-77,118-135
        exp = self.sf.header_get("experiment_type", 0)
        if exp is None:
            log_warning("experiment_type not found in SLOW5 header. Assuming genomic_dna")
        elif exp == "rna" and not opt.rna:
            opt.rna = True
            log_verbose("Detected RNA data. --rna was set automatically.")
        elif exp not in ("genomic_dna", "rna"):
            log_warning(f"Unknown experiment type: {exp}. Assuming genomic_dna")
        for g in range(1, self.sf.num_read_groups):
            curr = self.sf.header_get("experiment_type", g)
            if exp is not None and curr != exp:
                log_warning(
                    f"Experiment type mismatch: {curr} != {exp} in read "
                    f"group {g}. Defaulted to {exp}"
                )
        # the chemistry: --pore, else the header's sequencing_kit, else R9
        self.pore_flag = jnn.PORE_R9
        if opt.pore is None:
            kit = self.sf.header_get("sequencing_kit", 0)
            if kit is None:
                log_warning("sequencing_kit not found in SLOW5 header. Assuming R9.4.1")
            elif "114" in kit:
                self.pore_flag = jnn.PORE_R10
                log_verbose("Detected R10 data. --pore r10 was set automatically.")
                if opt.rna:
                    raise SystemExit("R10 RNA data does not exist! But header indicates R10 RNA.")
            elif "rna004" in kit:
                self.pore_flag = jnn.PORE_RNA004
                log_verbose("Detected RNA004 data. --pore rna004 was set automatically.")
            for g in range(1, self.sf.num_read_groups):
                curr = self.sf.header_get("sequencing_kit", g)
                if kit is not None and curr != kit:
                    log_warning(
                        f"sequencing_kit type mismatch: {curr} != {kit} in "
                        f"read group {g}. Defaulted to {kit}"
                    )
        else:
            self.pore_flag = {"r9": jnn.PORE_R9, "r10": jnn.PORE_R10,
                              "rna004": jnn.PORE_RNA004}[opt.pore]

        # samples-per-event estimate for the prefix-bounded eventization
        # fast path (_prefix_events); EMA-refined from real reads
        # (after auto-detection, so opt.rna is final)
        self._dwell_ema = 22.0 if opt.rna else 10.0
        self._dwell_lock = threading.Lock()

        W = max(opt.query_size, 1)
        if state is None:
            # --- model
            if opt.model_file:
                model = read_model_tsv(opt.model_file)
            elif opt.rna:
                if self.pore_flag == jnn.PORE_RNA004:
                    log_info("builtin RNA004 nucleotide model loaded")
                    model = load_builtin_model(MODEL_ID_RNA_RNA004)
                else:
                    log_info("builtin RNA R9 nucleotide model loaded")
                    model = load_builtin_model(MODEL_ID_RNA_R9)
            elif self.pore_flag == jnn.PORE_R10:
                log_info("builtin DNA R10 nucleotide model loaded")
                model = load_builtin_model(MODEL_ID_DNA_R10)
            else:
                log_info("builtin DNA R9 nucleotide model loaded")
                model = load_builtin_model(MODEL_ID_DNA_R9)
            # --- synthesized reference (RNA: forward 3'-end tracks of
            # min(1.5 q, L+1-k) events, their start offsets recorded;
            # --full-ref whole contigs, --from-end 5' ends, --invert the
            # 3' end's events reversed)
            self.ref: RefSynth = gen_ref(
                fasta_path, model, rna=opt.rna, full_ref=opt.full_ref,
                from_end=opt.from_end, invert=opt.invert, query_size=opt.query_size,
            )
            # --- device track layout: contig-major, '+' then '-' per
            # contig, '+' only for RNA (candidate insertion order decides
            # ties, ref sigfish.c:870-964); every segment aligned to the
            # query size so the candidate windows are a static reshape
            tracks: list[np.ndarray] = []
            track_meta: list[tuple[int, str]] = []
            for j in range(self.ref.num_ref):
                tracks.append(self.ref.forward[j])
                track_meta.append((j, "+"))
                if self.ref.reverse is not None:
                    tracks.append(self.ref.reverse[j])
                    track_meta.append((j, "-"))
            ref_cat, reset, offsets = pad_tracks(tracks, ckpt=opt.ckpt, align=W)
            state = core_state_from_numpy(
                model.level_mean, model.level_stdv, model.kmer_size,
                ref_cat, reset, offsets, [t.size for t in tracks], track_meta,
                self.ref.ref_st_offset,
            )
        else:
            if opt.rna and state.ref_st_offset is None:
                # an RNA track starts ref_st_offset bases into its contig;
                # without the offsets every PAF position would be short
                raise ValueError(
                    "an RNA run needs the state's ref_st_offset (each contig's "
                    "3'-end track start, core_state_from_numpy(..., ref_st_offset))"
                )
            self.ref = _ref_meta(fasta_path, state)
        self.state = state
        self.ref_cat = state.ref_cat
        self.reset = state.reset
        self.track_offsets = state.offsets
        self.track_sizes = state.track_sizes
        self.track_meta = state.track_meta
        self.pad_q = max(128, ((opt.query_size + 127) // 128) * 128)

        # --mesh DPxTP: the (dp, tp) grid of devices and its layout
        self.mesh = None       # rows of torch.devices (parallel.make_mesh)
        self.mesh_mode = None  # "tracks" or "ring"
        if opt.mesh:
            dp_s, tp_s = opt.mesh.lower().split("x")
            n_dp, n_tp = int(dp_s), int(tp_s)
            if n_dp * n_tp > 1:
                self._mesh_layout(n_dp, n_tp, W)

        # static column maps for the candidate reduction, on the device
        u_map, valid_map = build_column_maps(
            self.track_offsets, self.ref_cat.shape[0], track_sizes=self.track_sizes
        )
        self.u_dev = torch.from_numpy(u_map).to(self.device)
        self.valid_dev = torch.from_numpy(valid_map).to(self.device)
        self.valid_host = valid_map
        if self.mesh_mode is not None:
            self._mesh_buffers(u_map, valid_map, W)
        # wavefront reference buffers per Q, uploaded once per Core
        self._wf_cache: dict[int, tuple[torch.Tensor, torch.Tensor, int]] = {}
        # chunked-reference segments per (Q, ref_chunk), uploaded once
        self._wf_chunk_cache: dict[tuple[int, int], tuple] = {}
        # the scan engine's reference and resets (_scan_inputs)
        self._scan_bufs: tuple[torch.Tensor, torch.Tensor] | None = None
        # the clip fold's window numbering per qlen (clip_window_bases)
        self._clip_bases: dict[int, tuple[np.ndarray, int]] = {}
        # --dtw-std: each track's corner column, its last (its first,
        # when empty), and its diagonal in the wavefront's row, + W - 1
        self.std_corner_cols = np.array(
            [int(o) + max(int(n), 1) - 1
             for o, n in zip(self.track_offsets[:-1], self.track_sizes)],
            dtype=np.int64,
        )
        self.std_corner_diags = self.std_corner_cols + (W - 1)
        # how many times each device route ran: "oneshot" (sub-)batches,
        # "clip_pass" of them whose clipped rows the one-shot route's clip
        # pass served, "chunked" carry chains, "clip_fold" batches whose
        # clipped rows the chunked route's clip fold served, "mesh_tracks"
        # and "ring" batches of the two --mesh engines
        self.routes = {"oneshot": 0, "clip_pass": 0, "chunked": 0, "clip_fold": 0,
                       "mesh_tracks": 0, "ring": 0}
        self._routes_lock = threading.Lock()
        # added once a batch by submit_batch: the records decoded by the
        # native library and in Python, and the sDTW batch's rows, its
        # live reads and the bucket's padding
        self.counts = {"decode_native": 0, "decode_python": 0, "rows_live": 0,
                       "rows_padded": 0}
        # --profile-cpu on the card: CUDA event pairs around each route's
        # device work, read by span_seconds once the run has drained;
        # "host_stages": around each bucket's work on host_stream, in every
        # --host-stages device run on the card
        self.spans = {"oneshot": [], "chunked": [], "host_stages": [], "mesh_tracks": [],
                      "ring": []}
        # one one-shot submission at a time: each holds its (rows, D)
        # buffers until its launches are queued, and callers on several
        # threads (force_oneshot) would otherwise hold them all at once.
        # The device runs them in turn on one stream either way.
        self._oneshot_lock = threading.Lock()
        # --host-stages device on the card: the eventizer and polyA kernels
        # run on this stream, so their results never wait behind the
        # previous batch's sDTW on the current stream; stage_wait is the
        # host seconds spent waiting for their results, stage_sync the part
        # of it spent waiting for the kernels themselves (the rest is
        # assemble_events and the copies)
        self.host_stream = None
        if opt.host_stages == "device" and self.device.type == "cuda":
            self.host_stream = torch.cuda.Stream(self.device)
        self.stage_wait = 0.0
        self.stage_sync = 0.0
        # reads whose events took the host path in device mode: the event
        # cap overflowed, or the signal alone passed _DEV_EVENT_CELL_CAP
        self.host_event_reads = 0

        # counters (ref core_t)
        self.total_reads = 0
        self.sum_bytes = 0
        self.prefix_fail = 0
        self.ignored = 0
        self.too_short = 0
        self.load_db_time = 0.0
        self.process_db_time = 0.0
        self.output_time = 0.0
        self.parse_time = 0.0
        self.event_time = 0.0
        self.normalise_time = 0.0
        self.dtw_time = 0.0

        self._pool: _fut.ThreadPoolExecutor | None = None
        if opt.num_thread > 1:
            self._pool = _fut.ThreadPoolExecutor(max_workers=opt.num_thread)

    def _mesh_layout(self, n_dp: int, n_tp: int, W: int) -> None:
        """The --mesh grid and its reference layout, by the JAX Core's
        rule: with fewer tracks than TP, ring mode, all DP*TP devices on
        tp over the single-device layout cut by columns; else tracks mode,
        the tracks split over tp by shard_tracks. ref_cat, reset and
        track_offsets become the mesh's layout (the state keeps its own),
        and device the grid's first device, which runs everything but
        the mesh engines. The tracks come back from the state's offsets
        and sizes."""
        opt = self.opt
        devices = opt.mesh_devices
        if devices is None and self.device.type == "cpu":
            devices = ["cpu"] * (n_dp * n_tp)
        tracks = [self.ref_cat[o : o + n]
                  for o, n in zip(self.track_offsets[:-1].tolist(), self.track_sizes)]
        if len(tracks) < n_tp:
            # whole tracks cannot fill the shards (one --full-ref contig):
            # split by columns, and pass the DP carry around the ring
            self.mesh_mode = "ring"
            n_tp *= n_dp
            self.mesh = make_mesh(1, n_tp, devices)
            ref_cat, reset, offsets = pad_tracks(tracks, ckpt=opt.ckpt, align=W)
            R = ref_cat.shape[0]
            # + pad_q: the ring needs >= W-1 PAD diagonals after the last
            # real column to flush its emissions; sub-chunks of Ds = Rs /
            # ring_n_sub diagonals, a multiple of W and of the kernel's
            # tile. The scan's shards are a multiple of ckpt and W, whole
            # (the JAX Core's sizes for each engine)
            if self.use_pallas:
                Rs, self.ring_n_sub = ring_shape(
                    R + self.pad_q, n_tp, math.lcm(opt.ckpt, W, DIAG_TILE), opt.ref_chunk
                )
            else:
                Rs, self.ring_n_sub = ring_shape(R + self.pad_q, n_tp, math.lcm(opt.ckpt, W), -1)
            ref_cat = np.concatenate([ref_cat, np.full(n_tp * Rs - R, PAD, np.float32)])
            reset = np.concatenate([reset, np.zeros(n_tp * Rs - R, bool)])
            if R < reset.shape[0]:
                reset[R] = True
        else:
            self.mesh_mode = "tracks"
            self.mesh = make_mesh(n_dp, n_tp, devices)
            sref, sreset, soffs, assign = shard_tracks(tracks, n_tp, ckpt=opt.ckpt, align=W)
            Rs = sref.shape[1]
            # the gathered layout, shard-major: the original track order,
            # as the split is contiguous
            ref_cat, reset = sref.reshape(-1), sreset.reshape(-1)
            offsets = np.zeros(len(tracks) + 1, dtype=np.int64)
            for s, a in enumerate(assign):
                for li, gi in enumerate(a):
                    offsets[gi] = s * Rs + soffs[s, li]
            offsets[-1] = n_tp * Rs
        kinds = {d.type for row in self.mesh for d in row}
        if kinds != {self.device.type}:
            raise ValueError(f"mesh devices {sorted(kinds)} on a device={opt.device!r} run")
        self.device = self.mesh[0][0]
        self.shard_Rs = Rs
        self.ref_cat, self.reset, self.track_offsets = ref_cat, reset, offsets

    def _mesh_buffers(self, u_map: np.ndarray, valid_map: np.ndarray, W: int) -> None:
        """Each shard's buffers of the selected mode and engine on its
        device (one copy per device and shard), and a stream per shard.
        Tracks: the one-shot kernel's (1, D) ypad and rspad at pad_q,
        padded to the shards' common D (PAD values, a reset at each
        shard's pad boundary), and the shard's column maps. Ring: the
        shard's columns as (n_sub, 1, Ds) value and reset segments and
        its rows of the diagonal-indexed valid mask, vd[lane:] = valid[:R
        - lane]. The scan's: the shard's (Rs,) columns and resets, and
        its column maps (tracks) or column-indexed valid mask (ring)."""
        n_tp, Rs = len(self.mesh[0]), self.shard_Rs
        if not self.use_pallas:
            cols = (self.ref_cat.reshape(n_tp, Rs), self.reset.reshape(n_tp, Rs))
            maps = ((u_map.reshape(n_tp, Rs), valid_map.reshape(n_tp, Rs))
                    if self.mesh_mode == "tracks" else (valid_map.reshape(n_tp, Rs),))
            host = list(zip(*cols, *maps))
        elif self.mesh_mode == "tracks":
            pads = [prepare_wavefront_inputs(r, rs, self.pad_q) for r, rs in
                    zip(self.ref_cat.reshape(n_tp, Rs), self.reset.reshape(n_tp, Rs))]
            D = max(d for _, _, d in pads)
            ypad = np.full((n_tp, 1, D), PAD, dtype=np.float32)
            rspad = np.zeros((n_tp, 1, D), dtype=np.float32)
            for s, (yp, rp, d) in enumerate(pads):
                ypad[s, :, :d], rspad[s, :, :d] = yp, rp
                if d < D:
                    rspad[s, 0, d] = 1.0
            host = list(zip(ypad, rspad, u_map.reshape(n_tp, Rs), valid_map.reshape(n_tp, Rs)))
        else:
            lane, R = W - 1, self.ref_cat.shape[0]
            # every real column emits at a diagonal inside the layout
            # (the + pad_q of the ring's sizing)
            assert not valid_map[R - lane :].any()
            vd = np.zeros(R, dtype=bool)
            vd[lane:] = valid_map[: R - lane]
            seg = (n_tp, self.ring_n_sub, 1, Rs // self.ring_n_sub)
            host = list(zip(self.ref_cat.reshape(seg), self.reset.astype(np.float32).reshape(seg),
                            vd.reshape(seg[:2] + seg[3:])))
        on_dev: dict[tuple[str, int], tuple] = {}
        for row in self.mesh:
            for s, d in enumerate(row):
                if (str(d), s) not in on_dev:
                    on_dev[str(d), s] = tuple(
                        torch.from_numpy(np.ascontiguousarray(a)).to(d) for a in host[s])
        self._mesh_bufs = [[on_dev[str(d), s] for s, d in enumerate(row)] for row in self.mesh]
        self._mesh_streams = shard_streams(self.mesh)

    def _wavefront_inputs(self, Q: int) -> tuple[torch.Tensor, torch.Tensor, int]:
        """The (1, D) reference value and reset buffers for a Q-wide
        query batch, on the device for the life of the Core."""
        if Q not in self._wf_cache:
            ypad, rspad, D = prepare_wavefront_inputs(self.ref_cat, self.reset, Q)
            self._wf_cache[Q] = (
                torch.from_numpy(ypad).to(self.device),
                torch.from_numpy(rspad).to(self.device),
                D,
            )
        return self._wf_cache[Q]

    def _scan_inputs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The scan's (R,) reference values and resets, on the device for
        the life of the Core."""
        if self._scan_bufs is None:
            self._scan_bufs = (torch.from_numpy(self.ref_cat).to(self.device),
                               torch.from_numpy(self.reset).to(self.device))
        return self._scan_bufs

    def _chunked(self, Q: int, force_oneshot: bool = False) -> bool:
        """Whether a Q-wide batch takes the chunked route (that of the
        JAX package): ref_chunk > 0 always, 0 once R + Q passes
        CHUNK_AUTO_COLS, -1 never; force_oneshot never."""
        rc = self.opt.ref_chunk
        return not force_oneshot and (
            rc > 0 or (rc == 0 and self.ref_cat.shape[0] + Q > CHUNK_AUTO_COLS)
        )

    def _count_route(self, route: str, n: int = 1) -> None:
        with self._routes_lock:
            self.routes[route] += n

    @contextlib.contextmanager
    def _span(self, route: str):
        """The block is the trace span sf.sdtw.<route>, and when
        profiling on the card, CUDA events recorded around the device
        work queued inside it go into spans[route]: on the Core's
        device's current stream, the end behind the current streams of
        every --mesh device (where the shards' work ends)."""
        with span("sf.sdtw." + route):
            if not (self.opt.profile and self.device.type == "cuda"):
                yield
                return
            main = torch.cuda.current_stream(self.device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record(main)
            yield
            for d in {d for row in self.mesh or () for d in row} - {self.device}:
                main.wait_stream(torch.cuda.current_stream(d))
            e1.record(main)
            with self._routes_lock:
                self.spans[route].append((e0, e1))

    def span_seconds(self, route: str) -> float:
        """Device seconds inside spans[route] (a --profile-cpu run on the
        card, one batch in flight at a time, so no two spans overlap; for
        "host_stages" any run, its spans in order on one stream)."""
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in self.spans[route]) / 1e3

    def _submit_parts(self, submit, qb: np.ndarray, qlens: np.ndarray, force_oneshot: bool):
        """A batch of more than DEVICE_CHUNK rows as one handle of
        DEVICE_CHUNK-row submissions of `submit`; None when it fits one."""
        C = self.DEVICE_CHUNK
        if qb.shape[0] <= C:
            return None
        return dict(parts=[
            submit(qb[o : o + C], qlens[o : o + C], force_oneshot)
            for o in range(0, qb.shape[0], C)
        ])

    @staticmethod
    def _collect_parts(collect, handle: dict):
        """The results of a _submit_parts handle's parts, each array of
        them joined by rows."""
        outs = [collect(h) for h in handle["parts"]]
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(a) for a in zip(*outs))
        return np.concatenate(outs)

    def sdtw_candidates_collect(self, handle: dict) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a submitted batch's results and unpack them."""
        if "parts" in handle:
            return self._collect_parts(self.sdtw_candidates_collect, handle)
        if "native" in handle:
            return handle["native"]
        if "packed4" in handle:
            # the tracks engine: one (B/dp, 4k) buffer per grid row, the
            # W-window top-5 and the per-read-window top-5 side by side
            buf = np.concatenate([_host_array(c) for c in handle["packed4"]])[: handle["B"]]
            ts, tp = unpack_top5(buf[:, :10])
            qlens, W = handle["qlens"], self.opt.query_size
            rows = np.where((qlens > 0) & (qlens != W))[0]
            ts[rows], tp[rows] = unpack_top5(buf[rows, 10:])
            return ts, tp
        if handle["packed"] is None:
            # clip-only submission (every live row clipped): no main pass
            # ran; the clip entries below fill every real row
            B = handle["B"]
            ts = np.full((B, 5), np.float32(3.0e38), np.float32)
            tp = np.full((B, 5), -1, np.int32)
        else:
            ts, tp = unpack_top5(_host_array(handle["packed"]))
        if "clip_packed" in handle:
            cs, cp = unpack_top5(_host_array(handle["clip_packed"]))
            rows = handle["clip_rows"]
            ts[rows] = cs
            tp[rows] = cp
        if "clip_sub" in handle:
            # the ring's clipped rows, a padded single-device sub-batch
            cs, cp = self.sdtw_candidates_collect(handle["clip_sub"])
            rows = handle["clip_rows"]
            ts[rows] = cs[: rows.size]
            tp[rows] = cp[: rows.size]
        return ts, tp

    def _clip_pass(
        self, handle: dict, scores: torch.Tensor, qlens: np.ndarray, R: int, W: int,
        diag_lane: int | None,
    ) -> None:
        """Second device pass for clipped reads (qlen != W): their
        `scores` rows hold their correct qlen-1 rows, so this only
        re-derives the qlen-wide candidate windows. The wavefront's rows
        are diagonal-indexed (shift_queries_for_clip lands them on the
        kernel's emitted lane W-1): diag_lane=W-1 slices the column
        layout out of them, after the row take so only the clipped rows
        are materialized. The scan's (B, R) rows are by column already
        (its one-hot picks each row's qlen-1): diag_lane=None."""
        clip_rows = np.where((qlens > 0) & (qlens != W))[0]
        if not clip_rows.size:
            return
        self._count_route("clip_pass")
        rows_dev = torch.from_numpy(clip_rows).to(self.device)
        sub = scores.index_select(0, rows_dev)
        if diag_lane is not None:
            sub = sub[:, diag_lane : diag_lane + R]
        qlens_dev = torch.from_numpy(qlens[clip_rows].astype(np.int32)).to(self.device)
        cpacked = topk_candidates(
            sub, qlens_dev, self.u_dev, self.valid_dev, R, k=5, reindex=False, pack=True,
        )
        handle["clip_rows"] = clip_rows
        handle["clip_packed"] = _start_host_copy(cpacked)

    def sdtw_candidates_submit(
        self, qb: np.ndarray, qlens: np.ndarray, force_oneshot: bool = False,
        n_live: int | None = None,
    ) -> dict:
        """Launch the device work for one query batch without waiting for
        it; returns a handle for sdtw_candidates_collect, so the caller
        can overlap the next batch's host stages with this batch's
        device time.

        Routing (that of the JAX package): the native engine without a
        mesh on the host, its first n_live rows (the rest are bucket
        padding); on a --mesh grid the tracks or the ring engine, whole,
        with no DEVICE_CHUNK split; else the scan engine's one-shot scan,
        or the wavefront's routes: ref_chunk > 0 always takes the chunked
        route, 0 takes it once R + Q passes CHUNK_AUTO_COLS, -1 never
        does. force_oneshot takes the one-shot route on one device
        whatever the reference's length (to compare the routes)."""
        if self.engine == "native" and self.mesh is None:
            return self._native_candidates_submit(qb, qlens, n_live)
        if self.mesh_mode == "tracks" and not force_oneshot:
            return self._tracks_submit(qb, qlens)
        if self.mesh_mode == "ring" and not force_oneshot:
            return self._ring_submit(qb, qlens)
        return self._single_submit(qb, qlens, force_oneshot)

    def _tracks_submit(self, qb: np.ndarray, qlens: np.ndarray) -> dict:
        """The tracks engine (parallel.sharded_topk) over one batch, padded
        to a multiple of DP with full-length empty rows; its clipped reads
        are served in the same pass, by the per-read-window half."""
        B = qb.shape[0]
        W = self.opt.query_size
        if self.use_pallas:
            qb, _ = shift_queries_for_clip(qb, qlens, W - 1)
        padb = (-B) % len(self.mesh)
        qb = np.pad(qb, ((0, padb), (0, 0)))
        qlens_pad = np.pad(qlens.astype(np.int32), (0, padb), constant_values=max(W, 1))
        self._count_route("mesh_tracks")
        with self._oneshot_lock, self._span("mesh_tracks"):
            outs = sharded_topk(qb, qlens_pad, self._mesh_bufs, self.mesh, self._mesh_streams,
                                self.shard_Rs, W - 1, scan=not self.use_pallas)
            return dict(packed4=[_start_host_copy(o) for o in outs], qlens=qlens, B=B)

    def _ring_submit(self, qb: np.ndarray, qlens: np.ndarray) -> dict:
        """The ring engine (parallel.ring_topk, or ring_topk_scan on the
        scan) over one batch, in the largest count of microbatches up to
        32 that divides it. Clipped reads ride the ring (shifted on the
        wavefront; their W-window results are not read): their per-read
        windows straddle shard boundaries, so they are served again as
        one power-of-two sub-batch through the single-device route
        (one-shot or chunked by size on the wavefront, the scan on the
        scan) on the grid's first device, its pad rows of qlen 0."""
        B, Q = qb.shape
        W = self.opt.query_size
        n_micro = min(B, 32)
        while B % n_micro:
            n_micro -= 1
        self._count_route("ring")
        with self._span("ring"):
            if self.use_pallas:
                qb_k, fs = shift_queries_for_clip(qb, qlens, W - 1)
                out = ring_topk(qb_k, fs, self._mesh_bufs[0], self.mesh[0],
                                self._mesh_streams[0], n_micro, W - 1, W, self.shard_Rs)
            else:
                out = ring_topk_scan(qb, qlens, self._mesh_bufs[0], self.mesh[0],
                                     self._mesh_streams[0], n_micro, W, self.shard_Rs)
            handle = dict(packed=_start_host_copy(out), B=B)
        clip_rows = np.where((qlens > 0) & (qlens != W))[0]
        if clip_rows.size:
            bc = 1 << (int(clip_rows.size) - 1).bit_length()
            qb_c = np.zeros((bc, Q), dtype=qb.dtype)
            qb_c[: clip_rows.size] = qb[clip_rows]
            qlens_c = np.zeros(bc, dtype=qlens.dtype)
            qlens_c[: clip_rows.size] = qlens[clip_rows]
            handle["clip_rows"] = clip_rows
            handle["clip_sub"] = self._single_submit(qb_c, qlens_c)
        return handle

    def _single_submit(
        self, qb: np.ndarray, qlens: np.ndarray, force_oneshot: bool = False
    ) -> dict:
        """sdtw_candidates_submit on one device, the Core's."""
        parts = self._submit_parts(self._single_submit, qb, qlens, force_oneshot)
        if parts is not None:
            return parts
        B, Q = qb.shape
        R = self.ref_cat.shape[0]
        W = self.opt.query_size
        if not self.use_pallas:
            return self._scan_submit(qb, qlens)
        clip_rows = np.where((qlens > 0) & (qlens != W))[0]
        if self._chunked(Q, force_oneshot):
            return self._chunked_candidates_submit(qb, qlens, clip_rows)
        self._count_route("oneshot")
        ypad, rspad, _ = self._wavefront_inputs(Q)
        if clip_rows.size:
            # clipped reads ride the kernel's uniform emitted lane by
            # shifting their query up to end at lane W-1 (the free-start
            # lane moves with it via start_lanes)
            qb_k, fs_lanes = shift_queries_for_clip(qb, qlens, W - 1)
            fs_dev = torch.from_numpy(fs_lanes).to(self.device)
        else:
            qb_k, fs_dev = qb, None
        with self._oneshot_lock, self._span("oneshot"):
            scores = sdtw_wavefront(
                torch.from_numpy(qb_k).to(self.device), ypad, rspad,
                lane=W - 1, start_lanes=fs_dev,
            )
            packed = window_top5(
                scores, self.valid_dev, R, W, k=5, reindex=True, pack=True
            )
            handle = dict(packed=_start_host_copy(packed))
            self._clip_pass(handle, scores, qlens, R, W, diag_lane=W - 1)
        return handle

    def _scan_submit(self, qb: np.ndarray, qlens: np.ndarray) -> dict:
        """The scan engine's one-shot route on the Core's device: the
        column scan over the whole reference (each row's last row at its
        qlen - 1, so clipped reads need no query shift), the window top-5
        of its (B, R) row by column, and the clip pass on it. Counted as
        the one-shot route ("oneshot", "clip_pass")."""
        B, Q = qb.shape
        R = self.ref_cat.shape[0]
        W = self.opt.query_size
        self._count_route("oneshot")
        ref, reset = self._scan_inputs()
        q = torch.from_numpy(qb).to(self.device)
        with self._oneshot_lock, self._span("oneshot"):
            lr, _ = sdtw_scan(q, onehot_rows(qlens, Q, self.device), ref, reset)
            packed = window_top5(lr, self.valid_dev, R, W, k=5, reindex=False, pack=True)
            handle = dict(packed=_start_host_copy(packed))
            self._clip_pass(handle, lr, qlens, R, W, diag_lane=None)
        return handle

    def _engine_tracks(self) -> list[np.ndarray]:
        """Each track's values, views of the Core's layout."""
        return [self.ref_cat[o : o + n]
                for o, n in zip(self.track_offsets[:-1].tolist(), self.track_sizes)]

    def _native_candidates_submit(
        self, qb: np.ndarray, qlens: np.ndarray, n_live: int | None = None
    ) -> dict:
        """The native engine (the JAX Core's): each of the first n_live
        reads (all with None) at its own qlen through the exact host
        two-row DP over every track (native sf_subsequence; the exact
        numpy DP where the library is absent), on the thread pool (the
        native calls release the interpreter lock), then the host window
        scan and top-5. Bit-exact scalar order; clipped reads need no
        second pass. The results are in the handle before it returns."""
        from .. import native

        B = qb.shape[0]
        n = B if n_live is None else min(n_live, B)
        R = self.ref_cat.shape[0]
        tracks = self._engine_tracks()
        top_s = np.full((B, 5), np.float32(3.0e38))
        top_p = np.full((B, 5), -1, dtype=np.int64)

        def one(slot: int):
            qlen = int(qlens[slot])
            if qlen <= 0:
                return
            q = qb[slot, :qlen]
            lr = np.full(R, np.float32(3.0e38))
            for t, track in enumerate(tracks):
                lo = int(self.track_offsets[t])
                if track.size:
                    row = native.subsequence_lastrow(q, track, out=lr[lo : lo + track.size])
                    if row is None:  # native library unavailable: the exact oracle
                        from ..ops.sdtw_ref import subsequence_cost

                        lr[lo : lo + track.size] = subsequence_cost(q, track)[-1]
            top_s[slot], top_p[slot] = self._host_top5(lr, qlen)

        list(_pool_map(self._pool, one, range(n), chunk=1))
        return dict(native=(top_s, top_p))

    def _native_std_corners(
        self, qb: np.ndarray, qlens: np.ndarray, n_live: int | None = None
    ) -> np.ndarray:
        """--dtw-std on the native engine: each (read, track) corner cell
        of the boundary-anchored DTW (ref sigfish.c:914-925) by the exact
        host two-row DP (native sf_std_dtw; the numpy DP where the
        library is absent), on the thread pool. (B, ntracks) f32, BIG for
        the rows past n_live and the empty tracks."""
        from .. import native

        B = qb.shape[0]
        n = B if n_live is None else min(n_live, B)
        tracks = self._engine_tracks()
        corners = np.full((B, len(tracks)), np.float32(3.0e38))

        def one(slot: int):
            qlen = int(qlens[slot])
            if qlen <= 0:
                return
            q = qb[slot, :qlen]
            for t, track in enumerate(tracks):
                if track.size:
                    row = native.std_lastrow(q, track)
                    if row is None:  # native library unavailable: the exact oracle
                        from ..ops.sdtw_ref import std_dtw_cost

                        row = std_dtw_cost(q, track)[-1]
                    corners[slot, t] = row[-1]

        list(_pool_map(self._pool, one, range(n), chunk=1))
        return corners

    def _host_top5(self, lr_row: np.ndarray, qlen: int):
        """The window scan and update_aln top-5 of one read's last row
        (the reference's semantics at any window width): windows of qlen
        columns a track, the first minimum within a window, the later
        window on ties between windows."""
        cand_s: list[float] = []
        cand_p: list[int] = []
        for t, size in enumerate(self.track_sizes):
            lo = int(self.track_offsets[t])
            mins, args = window_argmin(lr_row[lo : lo + size], qlen)
            cand_s.extend(mins.tolist())
            cand_p.extend((args + lo).tolist())
        s = np.asarray(cand_s, dtype=np.float32)
        p = np.asarray(cand_p, dtype=np.int64)
        out_s = np.full(5, np.float32(3.0e38))
        out_p = np.full(5, -1, dtype=np.int64)
        for k in range(min(5, s.size)):
            best = s.size - 1 - int(np.argmin(s[::-1]))  # the later wins ties
            out_s[k] = s[best]
            out_p[k] = p[best]
            s[best] = np.float32(np.inf)
        return out_s, out_p

    def _chunk_inputs(self, Q: int) -> tuple:
        """The chunked route's segment buffers for a Q-wide batch (those of
        prepare_chunked_inputs and prepare_clip_inputs), on the device for
        the life of the Core: (ypad_seg, rspad_seg, valid_seg, track_seg,
        local_seg, nwin_tot)."""
        key = (Q, self.opt.ref_chunk)
        if key not in self._wf_chunk_cache:
            W = self.opt.query_size
            target = self.opt.ref_chunk if self.opt.ref_chunk > 0 else 32768
            yps, rps, vs, Ds, nwin_tot = prepare_chunked_inputs(
                self.ref_cat, self.reset, self.valid_host, Q, W, target=target
            )
            ts, ls = prepare_clip_inputs(self.track_offsets, self.track_sizes, W, vs.shape[0], Ds)
            self._wf_chunk_cache[key] = tuple(
                torch.from_numpy(a).to(self.device) for a in (yps, rps, vs, ts, ls)
            ) + (nwin_tot,)
        return self._wf_chunk_cache[key]

    def _chunked_candidates_submit(
        self, qb: np.ndarray, qlens: np.ndarray, clip_rows: np.ndarray
    ) -> dict:
        """The chunked-reference route (ops/chunked_ref.py): the carry
        kernel streams the reference in segments and folds each into
        per-window accumulators, so no (rows, D) score buffer ever
        exists, at any reference size. Bit-identical to the one-shot
        route (the kernel, window_top5 and the clip pass).

        Clipped reads (qlen != W) are shifted in place by
        shift_queries_for_clip and ride the batch's chain, whose every
        launch then takes their start lanes (full-length rows keep lane 0
        and their bits); their per-read window fold (ClipFold) reads their
        rows of each segment beside the W-window fold of the full-length
        rows. A batch whose every live row is clipped runs the clip fold
        alone."""
        W = self.opt.query_size
        B, Q = qb.shape
        dev = self.device
        yps, rps, vs, ts, ls, nwin_tot = self._chunk_inputs(Q)
        handle = dict(packed=None, B=B)
        window = clip = sl_dev = None
        if clip_rows.size < int(np.count_nonzero(qlens > 0)):
            window = WindowFold(B, vs, W, nwin_tot)
        if clip_rows.size:
            self._count_route("clip_fold")
            handle["clip_rows"] = clip_rows
            qb, sl = shift_queries_for_clip(qb, qlens, W - 1)
            sl_dev = torch.from_numpy(sl).to(dev)
            bases, n_win = clip_window_bases(self.track_sizes, qlens[clip_rows], self._clip_bases)
            clip = ClipFold(
                torch.from_numpy(clip_rows).to(dev), torch.from_numpy(qlens[clip_rows]).to(dev),
                torch.from_numpy(bases).to(dev), n_win, ts, ls, vs, W,
            )
        folds = [f for f in (window, clip) if f is not None]
        if not folds:
            return handle
        self._count_route("chunked")
        with self._span("chunked"):
            carry_chain(torch.from_numpy(qb).to(dev), yps, rps, W - 1, folds, sl_dev)
            if window is not None:
                handle["packed"] = _start_host_copy(window.top5())
            if clip is not None:
                handle["clip_packed"] = _start_host_copy(clip.top5())
        return handle

    def sdtw_std_corners_submit(
        self, qb: np.ndarray, qlens: np.ndarray, force_oneshot: bool = False,
        n_live: int | None = None,
    ) -> dict:
        """--dtw-std: launch the boundary-anchored sweep (the kernel's
        std instance) for one query batch and gather, on the device, each
        track's corner, the cell at its last column: std DTW's one
        candidate per track (ref sigfish.c:914-925). Only the (B,
        ntracks) corners come back (sdtw_std_corners_collect); no window
        top-5 and no clip pass run. Clipped reads ride the query shift of
        the subsequence path, their start lanes on every launch.

        The route is sdtw_candidates_submit's: past CHUNK_AUTO_COLS (or
        with ref_chunk > 0) the carry chain streams the reference and
        CornerFold gathers the corners segment by segment, bit for bit
        the one-shot corners: no host DP computes a corner, at any
        reference size. The scan engine runs its std mode over the whole
        reference (on a mesh too, over the mesh's layout, as the JAX Core
        does), each row's last row at its qlen - 1; the native engine
        without a mesh the exact host DP (_native_std_corners), its first
        n_live rows."""
        if self.engine == "native" and self.mesh is None:
            corners = self._native_std_corners(qb, qlens, n_live)
            return dict(corners=(torch.from_numpy(corners), None))
        parts = self._submit_parts(self.sdtw_std_corners_submit, qb, qlens, force_oneshot)
        if parts is not None:
            return parts
        B, Q = qb.shape
        W = self.opt.query_size
        dev = self.device
        if not self.use_pallas:
            self._count_route("oneshot")
            ref, reset = self._scan_inputs()
            cols = torch.from_numpy(self.std_corner_cols).to(dev)
            with self._oneshot_lock, self._span("oneshot"):
                lr, _ = sdtw_scan(torch.from_numpy(qb).to(dev), onehot_rows(qlens, Q, dev), ref,
                                  reset, std=True)
                corners = _start_host_copy(lr.index_select(1, cols))
            return dict(corners=corners)
        qb_k, fs = shift_queries_for_clip(qb, qlens, W - 1)
        q = torch.from_numpy(qb_k).to(dev)
        sl = torch.from_numpy(fs).to(dev)
        if self._chunked(Q, force_oneshot):
            self._count_route("chunked")
            yps, rps, vs = self._chunk_inputs(Q)[:3]
            fold = CornerFold(B, self.std_corner_diags, vs.shape[1], dev)
            with self._span("chunked"):
                carry_chain(q, yps, rps, W - 1, [fold], sl, std=True)
                corners = _start_host_copy(fold.corners)
            return dict(corners=corners)
        self._count_route("oneshot")
        ypad, rspad, _ = self._wavefront_inputs(Q)
        cols = torch.from_numpy(self.std_corner_diags).to(dev)
        with self._oneshot_lock, self._span("oneshot"):
            scores = sdtw_wavefront(q, ypad, rspad, lane=W - 1, start_lanes=sl, std=True)
            corners = _start_host_copy(scores.index_select(1, cols))
        return dict(corners=corners)

    def sdtw_std_corners_collect(self, handle: dict) -> np.ndarray:
        """Wait for a submitted batch's (B, ntracks) std corners."""
        if "parts" in handle:
            return self._collect_parts(self.sdtw_std_corners_collect, handle)
        return _host_array(handle["corners"])

    def close(self) -> None:
        self.sf.close()
        if self._pool:
            self._pool.shutdown()


@dataclass
class ReadWork:
    """Per-read transient state (one slot of db_t, ref sigfish.h:161-197)."""

    rec: Slow5Record | None = None
    event_start: np.ndarray | None = None
    event_length: np.ndarray | None = None
    event_mean: np.ndarray | None = None
    n_events: int = 0
    qstart: int = 0
    qend: int = 0
    query: np.ndarray | None = None  # z-scored (and RNA-reversed) slice
    pa: np.ndarray | None = None  # cached pA conversion (to_pa is pure)
    out: str | None = None
    # --host-stages device, RNA -p -1: the polyA end found on the device
    # (-1 = failed); None = not computed
    device_py: int | None = None
    skip: bool = False  # len_raw_signal==0 or ignored
    native_decode: bool = False  # the native library decoded the record
    # per-read counter flags, tallied by the main thread (avoids races)
    flag_prefix_fail: bool = False
    flag_ignored: bool = False
    flag_too_short: bool = False


def _parse_single(core: Core, blob: bytes) -> ReadWork:
    """ref: parse_single sigfish.c:317-328."""
    from .. import native

    w = ReadWork()
    w.rec = core.sf.decode_record(blob)
    w.native_decode = native.took_native_decode()
    if w.rec.len_raw_signal <= 0:
        w.skip = True
    return w


def _event_single(core: Core, w: ReadWork) -> ReadWork:
    """ref: event_single sigfish.c:330-378 (pA conversion + getevents)."""
    if w.skip:
        return w
    if w.pa is None:
        w.pa = w.rec.to_pa()
    et = get_events(w.pa, rna=core.opt.rna)
    w.event_start = et.start
    w.event_length = et.length
    w.event_mean = et.mean.copy()
    w.n_events = et.n
    if et.n <= 0:
        w.skip = True
    return w


# --host-stages device: ceiling on padded (Sb, Bb) eventization plane
# cells (that of the JAX package, so the same long reads take the host
# path). At the cap the kernel's two f64 prefix planes take 0.5 GB.
_DEV_EVENT_CELL_CAP = 1 << 25


def event_buckets(works: list[ReadWork], idx: list[int]):
    """The device eventizer's buckets of works[idx] (the JAX package's):
    reads sorted by signal length and chunked, each chunk padded to a
    power-of-two (Sb >= 1024, Bb) bucket, Bb >= min(64, max_b) with
    max_b = _DEV_EVENT_CELL_CAP // Sb. Yields (chunk, signals (Bb, Sb)
    i16, nsamples, digitisation, offset, range) per bucket; the chunk's
    reads fill its first rows. The output does not depend on the
    chunking, but the limits decide which long reads take the host path."""
    idx = sorted(idx, key=lambda i: works[i].rec.len_raw_signal)
    c0 = 0
    while c0 < len(idx):
        S = works[idx[c0]].rec.len_raw_signal
        Sb = 1024
        while Sb < S:
            Sb *= 2
        max_b = max(1, _DEV_EVENT_CELL_CAP // Sb)
        c1 = c0 + 1
        while c1 < len(idx) and c1 - c0 < max_b and works[idx[c1]].rec.len_raw_signal <= Sb:
            c1 += 1
        chunk = idx[c0:c1]
        c0 = c1
        Bb = min(64, max_b)
        while Bb < len(chunk):
            Bb *= 2
        sig = np.zeros((Bb, Sb), np.int16)
        ns = np.zeros(Bb, np.int32)
        digi = np.full(Bb, 1.0)
        off = np.zeros(Bb)
        rng_pa = np.full(Bb, 1.0)
        for r, i in enumerate(chunk):
            rec = works[i].rec
            sig[r, : rec.len_raw_signal] = rec.raw_signal
            ns[r] = rec.len_raw_signal
            digi[r] = rec.digitisation
            off[r] = rec.offset
            rng_pa[r] = rec.range
        yield chunk, sig, ns, digi, off, rng_pa


def _event_batch_device(core: Core, works: list[ReadWork]) -> None:
    """--host-stages device: eventize the batch on the device instead of
    per read on the host, and with RNA -p -1 (not --from-end) find each
    read's polyA end there too (device_py). Fills event_start/length/mean
    and n_events in place. A read whose signal alone passes
    _DEV_EVENT_CELL_CAP, or whose events overflow its bucket's cap, takes
    the exact host path (_event_single); core.host_event_reads counts them.
    Output-identical to the host mode: the tables are bit-equal to
    _event_single's. On the card the work runs on core.host_stream, and
    this thread waits only on events recorded behind it."""
    opt = core.opt
    idx = [i for i, w in enumerate(works) if not w.skip]
    long_idx = [i for i in idx if works[i].rec.len_raw_signal > _DEV_EVENT_CELL_CAP]
    for i in long_idx:
        _event_single(core, works[i])
    core.host_event_reads += len(long_idx)
    drop = set(long_idx)
    want_py = opt.rna and opt.prefix_size < 0 and not opt.from_end
    stream = core.host_stream
    for chunk, sig, ns, digi, off, rng_pa in event_buckets(
        works, [i for i in idx if i not in drop]
    ):
        with torch.cuda.stream(stream):  # no stream on the CPU: a no-op
            if stream is not None:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record(stream)
            args = batch_tensors(sig, ns, digi, off, rng_pa, core.device)
            res = detect_peaks(*args, opt.rna, event_cap(sig.shape[1]))
            pys = polya_end(*args, core.pore_flag) if want_py else None
            if stream is not None:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record(stream)
                core.spans["host_stages"].append((e0, e1))
            t0 = time.time()
            if stream is not None:
                e1.synchronize()
                core.stage_sync += time.time() - t0
            tables, _ = assemble_events(res, ns)
            if pys is not None:
                pys = to_host(pys)
            core.stage_wait += time.time() - t0
        for r, i in enumerate(chunk):
            w = works[i]
            if pys is not None:
                w.device_py = int(pys[r])
            et = tables[r]
            if et is None:  # the bucket's event cap overflowed: host path
                core.host_event_reads += 1
                _event_single(core, w)
                continue
            w.event_start = et.start
            w.event_length = et.length
            w.event_mean = et.mean.copy()
            w.n_events = et.n
            if et.n <= 0:
                w.skip = True


def _normalise_single(core: Core, w: ReadWork, py: int | None = None) -> ReadWork:
    """ref: normalise_single sigfish.c:424-505 (query window + z-score).
    The window starts after a fixed prefix (-p >= 0), or with -p -1 at
    the first event at or after the polyA tail's end; with --from-end it
    ends the prefix's events before the read's last event.

    py: the polyA end's sample index when already known (the prefix
    path's, so the adaptor and polyA scans are not repeated); None =
    compute here, -1 = computed and failed."""
    if w.skip:
        return w
    opt = core.opt
    n = w.n_events
    if not opt.from_end:
        start_idx = opt.prefix_size
        if opt.prefix_size < 0:
            if py is None:
                if w.pa is None:
                    w.pa = w.rec.to_pa()
                py = jnn.detect_polya_end(w.rec.raw_signal, w.pa, pore=core.pore_flag)
            if py < 0:
                start_idx = -1
            else:
                # first event with start >= py, linear first-match
                # (ref sigfish.c:405-411)
                ge = np.nonzero(w.event_start.astype(np.int64) >= py)[0]
                start_idx = int(ge[0]) if ge.size else -1
            if start_idx < 0:
                w.flag_prefix_fail = True
                start_idx = 50  # fall back, ref sigfish.c:440-447
        end_idx = start_idx + opt.query_size
        if start_idx + 25 > n:  # min query size 25, ref sigfish.c:450-456
            w.skip = True
            w.flag_ignored = True
            return w
        if end_idx > n:
            end_idx = n
            w.flag_too_short = True
    else:
        start_idx = n - opt.prefix_size - opt.query_size
        end_idx = n - opt.prefix_size
        if start_idx < 0:
            start_idx = 0
            w.flag_too_short = True
        if end_idx < 0:
            w.skip = True
            w.flag_ignored = True
            return w
    if end_idx <= start_idx:
        # empty query window (--from-end with n_events == prefix, or
        # -q 0): counted as ignored, as the JAX package does (PARITY.md
        # Robustness)
        w.skip = True
        w.flag_ignored = True
        return w
    return _finish_normalise(core, w, int(start_idx), int(end_idx))


def _finish_normalise(core: Core, w: ReadWork, start_idx: int, end_idx: int) -> ReadWork:
    """Window z-score + RNA reversal given the decided query window.

    ref sigfish.c:479-502 (shared by the exact path and the
    prefix-bounded fast path -- identical math on identical inputs)."""
    w.qstart = start_idx
    w.qend = end_idx

    # z-score the slice, float32 population stats in the reference's
    # sequential accumulation order (ref sigfish.c:483-502)
    from .. import native

    sl = np.ascontiguousarray(w.event_mean[start_idx:end_idx], np.float32)
    if native.zscore_inplace(sl):
        sl_norm = sl
    else:
        num = np.float32(end_idx - start_idx)
        mean = np.float32(sl.sum(dtype=np.float32) / num)
        var = np.float32(np.sum((sl - mean) * (sl - mean), dtype=np.float32) / num)
        stdv = np.float32(np.sqrt(var))
        sl_norm = (sl - mean) / stdv
    w.event_mean[start_idx:end_idx] = sl_norm
    # RNA runs 3' to 5' through the pore: the query is reversed to meet
    # the forward track (ref sigfish.c:860-867), unless --invert reversed
    # the reference's events instead
    w.query = sl_norm[::-1].copy() if core.opt.rna and not core.opt.invert else sl_norm.copy()
    assert w.query.size == end_idx - start_idx
    return w


def _read_events(core: Core, w: ReadWork) -> tuple[int | None, int]:
    """The events stage of _prepare_reads for one record: (py,
    start_idx). start_idx >= 0: the prefix-bounded path (_prefix_events)
    settled the query window, and w's event table is the safe prefix's;
    -1: w's events are the whole signal's (the exact path), with py the
    polyA end to hand _normalise_single (None: it finds its own)."""
    if w.skip:
        return None, -1
    opt = core.opt
    if opt.from_end or opt.query_size <= 0:
        # --from-end counts its window from the last event, which a
        # signal prefix cannot know; the exact path ignores an empty
        # query window
        _event_single(core, w)
        return None, -1
    py, start_idx = _prefix_events(core, w)
    if start_idx < 0:
        # exact full-signal path; hand over the polyA result so the
        # adaptor/polyA scans are not repeated
        _event_single(core, w)
        return (py if opt.prefix_size < 0 else None), -1
    return py, start_idx


def _prefix_events(core: Core, w: ReadWork) -> tuple[int, int]:
    """Prefix-bounded events for one read: (py, start_idx), the polyA
    end (-1 with -p >= 0) and the query's first event, w's event table
    the safe prefix's; start_idx -1 where the prefix cannot settle the
    window (the exact path's to do).

    The query window only needs events up to qstart + query_size, and
    event detection is a causal left-to-right scan, so eventizing a
    grown signal PREFIX reproduces the leading events bit-exactly
    (ops/events.py detect_events_prefix safety contract). With -p -1 the
    polyA end py is found first, on the raw signal, and the query starts
    at the first event at or after it: that answer counts only once an
    event at or after py lies inside the safe prefix, else the prefix
    grows. The caller falls back to the exact full-signal path (handing
    it py) for clipped/ignored reads or when no samples would be saved;
    the output is bit-identical to that path."""
    opt = core.opt
    if w.pa is None:
        w.pa = w.rec.to_pa()
    pa = w.pa
    n = pa.size
    rna = opt.rna
    w2 = (RNA_PARAMS if rna else DNA_PARAMS)["window_length2"]
    q = opt.query_size
    need_past_start = max(q, 25)  # covers the ignored(<start+25) and
    # too_short(end>n) decisions: n_events >= start + max(q,25) forces
    # both checks to the not-clipped branch, matching the full run

    if opt.prefix_size >= 0:
        py = -1
        start_known = opt.prefix_size
    else:
        py = jnn.detect_polya_end(w.rec.raw_signal, pa, pore=core.pore_flag)
        if py < 0:
            w.flag_prefix_fail = True
            start_known = 50  # ref sigfish.c:440-447 fallback
        else:
            start_known = -1  # first event at/after py, from the table

    # initial samples-per-event guess: per-Core EMA of the measured
    # density (seeded per chemistry), margin 1.3; a short retry refines
    # the bound from the observed event table
    dwell = core._dwell_ema
    if start_known >= 0:
        S = int((start_known + need_past_start + 2) * dwell * 1.3)
    else:
        S = py + int((q + 30) * dwell * 1.3)
    S += 4 * w2 + 64
    for _ in range(4):
        if S >= n:
            break
        et, n_safe = get_events_prefix(pa[:S], rna, S - w2)
        if n_safe >= 16:
            starts = et.start[:n_safe].astype(np.int64)
            if start_known < 0:
                # first event with start >= py, linear first-match like
                # the reference (sigfish.c:405-407): a match inside the
                # safe prefix equals the full-table scan's result; no
                # match yet means the answer is not settled -- grow
                ge = np.nonzero(starts >= py)[0]
                start_idx = int(ge[0]) if ge.size else -1
            else:
                start_idx = start_known
            needed = (start_idx if start_idx >= 0 else n_safe) + need_past_start
            if start_idx >= 0 and n_safe >= needed:
                # guarded read-modify-write: thread-pool workers update
                # the EMA concurrently and a lost update would make the
                # prefix-size estimate nondeterministic run to run
                with core._dwell_lock:
                    core._dwell_ema = 0.9 * core._dwell_ema + 0.1 * (
                        float(starts[-1]) / n_safe
                    )
                w.event_start = et.start[:n_safe]
                w.event_length = et.length[:n_safe]
                w.event_mean = et.mean[:n_safe].copy()
                w.n_events = n_safe
                return py, start_idx
            # refine the bound from the observed local event density
            k = min(64, n_safe - 1)
            d_loc = float(starts[-1] - starts[-1 - k]) / k
            missing = needed - n_safe + 8
            S = int(starts[-1] + missing * d_loc * 1.3) + 4 * w2 + 64
        else:
            S *= 3
    return py, -1


def _prepare_reads(core: Core, blobs: list[bytes]) -> list[ReadWork]:
    """Fused parse + event + normalise for a pool chunk of records
    (default mode), each stage over the chunk in turn, so each is one
    trace span a chunk (sf.decode, sf.events, sf.normalise): a range a
    read would cost more than the stage's own work in a traced run.

    ref: work_per_single_read sigfish.c:995-1001. The events are
    prefix-bounded (_prefix_events) where that settles the window, else
    the whole signal's (_read_events).
    """
    with span("sf.decode"):
        works = [_parse_single(core, b) for b in blobs]
    with span("sf.events"):
        found = [_read_events(core, w) for w in works]
    q = core.opt.query_size
    with span("sf.normalise"):
        return [
            _normalise_single(core, w, py=py) if st < 0 else _finish_normalise(core, w, st, st + q)
            for w, (py, st) in zip(works, found)
        ]


def _prepare_read(core: Core, blob: bytes) -> ReadWork:
    """_prepare_reads of one record."""
    return _prepare_reads(core, [blob])[0]


def _backtrack_best(
    core: Core, w: ReadWork, track_idx: int, pos_local: int
) -> tuple[int, np.ndarray | None]:
    """Recover pos_st for the winner, and with --sam the reference-to-
    query-event map of its path.

    Recomputes a fresh DP column window ending at the winning column and
    backtracks greedily -- exact because subsequence DTW has a free start
    on the reference axis. If the path touches the window's left edge
    the window is widened and recomputed. Standard DTW (--dtw-std) is
    boundary-anchored, so its window is always the full track prefix.
    Replaces the reference's O(qlen x rlen) matrix retention
    (src/sigfish.c:873, src/cdtw.c:120).
    """
    from .. import native

    opt = core.opt
    track_start = int(core.track_offsets[track_idx])
    pos_global = track_start + pos_local
    qlen = w.query.size
    span = pos_local + 1 if opt.dtw_std else min(max(2 * qlen, 64), pos_local + 1)
    while True:
        j_lo = pos_global + 1 - span
        ref_cols = core.ref_cat[j_lo : pos_global + 1]
        if native.available():
            px, py = native.subsequence_backtrack(w.query, ref_cols, span - 1, std=opt.dtw_std)
        else:
            cost = subsequence_cost_seeded(w.query, ref_cols, None, std=opt.dtw_std)
            px, py = subsequence_path(cost, span - 1)
        if py[0] == 0 and j_lo > track_start:
            # path touched the recompute window's left edge: widen
            span = min(span * 2, pos_local + 1)
            continue
        break
    pos_st_local = int(py[0]) + (j_lo - track_start)
    r2q = path_to_map(px, py, pos_local - pos_st_local + 1) if opt.sam else None
    return pos_st_local, r2q


@dataclass
class PendingBatch:
    """A batch whose device work has been launched but not collected."""

    works: list
    stats: BatchStats
    live: list
    handle: dict | None = None
    dtw_t0: float = 0.0


def _start_host_copy(t: torch.Tensor):
    """Start the device->host copy of a result without waiting for it:
    a non-blocking copy into pinned memory, with a CUDA event recorded
    behind it on the producing stream. _host_array waits on that event
    before reading (reading a non-blocking copy early yields garbage).
    CPU tensors are returned as they are."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return host, ev


def _host_array(copy) -> np.ndarray:
    """The numpy array of a _start_host_copy result, once it has landed."""
    host, ev = copy
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def _pool_chunks(pool, fn, items, chunk: int = 32):
    """Order-preserving parallel map of fn, which maps a list to a list
    of as many, over chunks of ~chunk items: one future a chunk."""
    items = list(items)
    if pool is None or len(items) <= chunk:
        return fn(items)
    slices = [items[i : i + chunk] for i in range(0, len(items), chunk)]
    return [y for ch in pool.map(fn, slices) for y in ch]


def _pool_map(pool, fn, items, chunk: int = 32):
    """Order-preserving parallel map in chunks: one future per ~chunk
    items instead of one per item."""
    return _pool_chunks(pool, lambda sl: [fn(x) for x in sl], items, chunk)


def submit_batch(core: Core, blobs: list[bytes]) -> PendingBatch:
    """Host stages + asynchronous device launch for one batch of raw records."""
    opt = core.opt
    stats = BatchStats(n_rec=len(blobs), sum_bytes=sum(len(b) for b in blobs))

    # ---- host stages (parallel over reads); --profile-cpu runs them
    # stage-by-stage with per-stage wall-clock accumulation
    # (ref: process_db sigfish.c:1021-1042)
    def _map(fn, items, name):
        def each(sl):  # a chunk is one trace span
            with span(name):
                return [fn(x) for x in sl]
        return _pool_chunks(core._pool, each, items)

    device_stages = opt.host_stages == "device"
    with span("sf.prep"):
        if opt.profile:
            t0 = time.time()
            works = _map(lambda b: _parse_single(core, b), blobs, "sf.decode")
            core.parse_time += time.time() - t0
            t0 = time.time()
            if device_stages:
                with span("sf.events"):
                    _event_batch_device(core, works)
            else:
                works = _map(lambda w: _event_single(core, w), works, "sf.events")
            core.event_time += time.time() - t0
            t0 = time.time()
            works = _map(lambda w: _normalise_single(core, w, py=w.device_py), works,
                         "sf.normalise")
            core.normalise_time += time.time() - t0
        elif device_stages:
            # parse on the pool, the batch's events (and polyA ends) on
            # the device from this thread, then the per-read windows on
            # the pool
            works = _map(lambda b: _parse_single(core, b), blobs, "sf.decode")
            with span("sf.events"):
                _event_batch_device(core, works)
            works = _map(lambda w: _normalise_single(core, w, py=w.device_py), works,
                         "sf.normalise")
        else:
            works = _pool_chunks(core._pool, lambda sl: _prepare_reads(core, sl), blobs)
        dtw_t0 = time.time()

        n_native = 0
        for w in works:
            n_native += w.native_decode
            stats.prefix_fail += w.flag_prefix_fail
            stats.ignored += w.flag_ignored
            stats.too_short += w.flag_too_short

        live = [i for i, w in enumerate(works) if not w.skip]
        pending = PendingBatch(works=works, stats=stats, live=live, dtw_t0=dtw_t0)
        nb = bucket = 0
        if live:
            # ---- device stage: pad the batch to a 64 / power-of-two bucket
            queries = [works[i].query for i in live]
            nb = len(queries)
            bucket = 64
            while bucket < nb:
                bucket *= 2
            bucket = min(bucket, max(64, opt.batch_size))
            while len(queries) < bucket:
                # dummy slots carry a full-width zero query so they ride
                # the uniform candidate path (their results are never read)
                queries.append(np.zeros(max(opt.query_size, 1), dtype=np.float32))
            qb, qlens, _ = make_query_batch(queries, pad_q=core.pad_q)
    with core._routes_lock:
        c = core.counts
        c["decode_native"] += n_native
        c["decode_python"] += len(works) - n_native
        c["rows_live"] += nb
        c["rows_padded"] += bucket - nb
    if not live:
        return pending
    with span("sf.sdtw_queue"):
        if opt.dtw_std:
            pending.handle = core.sdtw_std_corners_submit(qb, qlens, n_live=nb)
        else:
            pending.handle = core.sdtw_candidates_submit(qb, qlens, n_live=nb)
    return pending


def finish_batch(core: Core, pending: PendingBatch) -> tuple[list[str | None], BatchStats]:
    """Collect device results, backtrack winners, format output lines."""
    opt = core.opt
    works = pending.works
    stats = pending.stats
    live = pending.live
    if not live:
        if opt.profile:
            core.dtw_time += time.time() - pending.dtw_t0
        return [None] * len(works), stats
    offs = core.track_offsets
    with span("sf.collect"):
        if opt.dtw_std:
            corners = core.sdtw_std_corners_collect(pending.handle)
            # std DTW's candidates: one per non-empty track, its corner, in
            # track order (ref sigfish.c:914-925)
            cand_track = [t for t, size in enumerate(core.track_sizes) if size > 0]
            cand_pos = np.asarray([core.track_sizes[t] - 1 for t in cand_track])
        else:
            top_s, top_p = core.sdtw_candidates_collect(pending.handle)

    with span("sf.format"):
        # pass 1: winner selection per read (cheap host work)
        winners = []  # (w, t, pos_end_local, d1, d2, rid, strand)
        for slot, i in enumerate(live):
            w = works[i]
            if opt.dtw_std:
                best, d1, d2 = rank_candidates(corners[slot, cand_track], cand_pos)
                if best < 0:
                    w.out = None
                    continue
                t = cand_track[best]
                pos_end_local = int(cand_pos[best])
            else:
                s0 = float(top_s[slot, 0])
                if top_p[slot, 0] < 0 or s0 >= 1e37:
                    w.out = None
                    continue
                d1 = s0
                d2 = float(top_s[slot, 1])
                if d2 >= 1e37:
                    d2 = float("inf")
                pos_global = int(top_p[slot, 0])
                t = int(np.searchsorted(offs, pos_global, side="right")) - 1
                pos_end_local = pos_global - int(offs[t])
            rid, strand = core.track_meta[t]
            winners.append((w, t, pos_end_local, d1, d2, rid, strand))

    # pass 2: winner backtracks (native calls release the GIL -> the
    # thread pool parallelizes them on multi-core hosts)
    with span("sf.backtrack"):
        paths = _pool_map(
            core._pool, lambda a: _backtrack_best(core, a[0], a[1], a[2]), winners
        )

    with span("sf.format"):
        # pass 3: coordinates + formatting
        for (w, t, pos_end_local, d1, d2, rid, strand), (pos_st_local, r2q) in zip(winners, paths):
            # strand flip, ref sigfish.c:971-977
            rlen = core.ref.ref_lengths[rid]
            if strand == "+":
                pos_st, pos_end = pos_st_local, pos_end_local
            else:
                pos_st, pos_end = rlen - pos_end_local, rlen - pos_st_local
            pos_st += core.ref.ref_st_offset[rid]
            pos_end += core.ref.ref_st_offset[rid]

            mapq = compute_mapq(d1, d2)

            # raw index recovery, ref aln_to_str sigfish.c:796-815
            start_ev = w.qstart
            end_ev = w.qend - 1
            start_raw = int(w.event_start[start_ev])
            end_raw = int(w.event_start[end_ev]) + int(np.float32(w.event_length[end_ev]))
            query_size = end_ev - start_ev
            if opt.sam:
                w.out = sam_line(
                    w.rec.read_id,
                    strand,
                    core.ref.ref_names[rid],
                    pos_st,
                    pos_end,
                    mapq,
                    query_size,
                    start_raw,
                    end_raw,
                    w.qstart,
                    r2q,
                    w.event_start,
                    w.event_length,
                    opt.rna,
                )
            else:
                w.out = paf_line(
                    w.rec.read_id,
                    w.rec.len_raw_signal,
                    start_raw,
                    end_raw,
                    strand,
                    core.ref.ref_names[rid],
                    core.ref.ref_seq_lengths[rid],
                    pos_st,
                    pos_end,
                    d1,
                    d2,
                    mapq,
                    query_size,
                )

    if opt.profile:
        core.dtw_time += time.time() - pending.dtw_t0
    return [w.out for w in works], stats


def process_batch(core: Core, blobs: list[bytes]) -> tuple[list[str | None], BatchStats]:
    """Map one batch of raw records; returns per-read output lines."""
    return finish_batch(core, submit_batch(core, blobs))


def run_dtw(core: Core, out_fp) -> None:
    """The batch loop, double-buffered: batch N+1's host stages (decode,
    eventization, normalisation) run while batch N's sDTW executes on the
    device -- CUDA launches are asynchronous, so submit_batch returns
    before the device finishes. Batch N's drain (waiting for its results
    + backtrack + output) runs on a single ordered worker thread, started
    BEFORE batch N+1's host stages; it waits on the CUDA events recorded
    behind the launches, not on the whole device. --profile-cpu drains
    each batch before submitting the next so the per-stage timers are
    unoverlapped.

    ref: dtw_main.c:299-326 (sequential load->process->output loop).
    """
    import sys

    opt = core.opt
    realtime0 = time.time()
    state = {"counter": 0}
    tlock = threading.Lock()

    def progress(n_rec: int, n_bytes: int, verb: str) -> None:
        # reference-format stderr line: [dtw_main::REALTIME*CPULOAD]
        rt = time.time() - realtime0
        cpu = sum(os.times()[:2]) / rt if rt > 0 else 0.0
        sys.stderr.write(
            f"[dtw_main::{rt:.3f}*{cpu:.2f}] {n_rec} Entries "
            f"({n_bytes/1e6:.1f}M bytes) {verb}\n"
        )

    def drain(pending: PendingBatch) -> None:
        t0 = time.time()
        lines, stats = finish_batch(core, pending)
        with tlock:  # submit_batch on the main thread also accumulates
            core.process_db_time += time.time() - t0
        progress(stats.n_rec, stats.sum_bytes, "processed")
        t0 = time.time()
        with span("sf.output"):
            for line in lines:
                if line is not None:
                    out_fp.write(line)
            out_fp.flush()
        core.output_time += time.time() - t0
        core.total_reads += stats.n_rec
        core.sum_bytes += stats.sum_bytes
        core.prefix_fail += stats.prefix_fail
        core.ignored += stats.ignored
        core.too_short += stats.too_short
        state["counter"] += 1
        # fault-injection hook (tests only): simulate a host crashing
        # mid-run after N drained batches -- the distributed peers must
        # fail fast with a named diagnosis, never hang
        # (tests/test_torch_distributed.py::test_mid_run_peer_death_fails_fast)
        die_after = os.environ.get("SIGFISH_TPU_DIE_AFTER_BATCH")
        if die_after is not None and state["counter"] >= int(die_after):
            os._exit(9)

    drainer = _fut.ThreadPoolExecutor(max_workers=1)  # ordered drains
    drain_fut: _fut.Future | None = None
    pending: PendingBatch | None = None
    done = False
    consumed = 0
    try:
        while not done:
            if pending is not None and not opt.profile:
                # start batch N's drain BEFORE batch N+1's load AND host
                # stages
                drain_fut = drainer.submit(drain, pending)
                pending = None
            t0 = time.time()
            max_recs = opt.batch_size
            if opt.rec_limit is not None:
                max_recs = min(max_recs, opt.rec_limit - consumed)
            with span("sf.read"):
                blobs = (
                    core.sf.read_batch(
                        max_recs, opt.batch_size_bytes,
                        shard_id=opt.shard_id, n_shards=opt.n_shards,
                    )
                    if max_recs > 0
                    else []
                )
            consumed += len(blobs)
            core.load_db_time += time.time() - t0
            new_pending = None
            if blobs:
                progress(len(blobs), sum(len(b) for b in blobs), "loaded")
                if opt.profile and pending is not None:
                    drain(pending)  # unoverlapped per-stage timers
                    pending = None
                t0 = time.time()
                new_pending = submit_batch(core, blobs)
                with tlock:
                    core.process_db_time += time.time() - t0
                if (
                    len(blobs) < opt.batch_size
                    and new_pending.stats.sum_bytes < opt.batch_size_bytes
                ):
                    done = True
            else:
                done = True

            if drain_fut is not None:
                with span("sf.drain_wait"):
                    drain_fut.result()
                drain_fut = None
            elif pending is not None:
                drain(pending)
            pending = new_pending
            if (
                pending is not None
                and opt.debug_break >= 0
                and state["counter"] > opt.debug_break
            ):
                pending = None
                done = True

        if pending is not None:
            if opt.debug_break < 0 or state["counter"] <= opt.debug_break:
                drain(pending)
    finally:
        drainer.shutdown(wait=True)
