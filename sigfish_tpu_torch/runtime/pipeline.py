"""The dtw pipeline: stream BLOW5 batches, map on the GPU, emit PAF.

The single-device subsequence path of sigfish_tpu/runtime/pipeline.py,
with its names and order kept:

  load_db       host   sequential raw-record fetch (src/sigfish.c:274)
  parse/event/
  normalise     host   per read, on a thread pool (native C++ where
                       built), ref sigfish.c:317-505
  sDTW +
  candidates    DEVICE the wavefront sDTW kernel (csrc/wavefront.cu via
                       ops/sdtw_wavefront.py) over every (contig, strand)
                       track for the whole batch, then the window top-5
                       reduction (ops/candidates_dev.py) on the scores'
                       device; only (B, 10) packed values come back
  backtrack/
  output        host   winner path recompute + PAF lines in batch order

Device selection: Options.device ("cuda" by default). CUDA tensors go
through the kernel, CPU tensors (device="cpu") through its plain
PyTorch version. There is no engine choice and no silent fallback:
Core raises when CUDA is asked for and absent.

This slice serves R9 DNA subsequence DTW with PAF output on one device.
Every other option raises NotImplementedError naming the ROADMAP.md
item (queue 1) that brings it.
"""

from __future__ import annotations

import concurrent.futures as _fut
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
from ..models.pore_model import MODEL_ID_DNA_R9, load_builtin_model, read_model_tsv
from ..ops.candidates import compute_mapq
from ..ops.candidates_dev import topk_candidates, window_top5
from ..ops.events import DNA_PARAMS, get_events, get_events_prefix
from ..ops.layout import (
    build_column_maps,
    make_query_batch,
    pad_tracks,
    prepare_wavefront_inputs,
    shift_queries_for_clip,
    unpack_top5,
)
from ..ops.sdtw_ref import subsequence_cost_seeded, subsequence_path
from ..ops.sdtw_wavefront import sdtw_wavefront
from ..output import paf_line
from ..utils import log_info, log_warning

# reference columns past which the JAX package streams the reference in
# segments (its ops/chunked_ref.CHUNK_AUTO_COLS); the port has no
# chunked path yet
CHUNK_AUTO_COLS = 1 << 20

# what brings each option that this slice does not serve (ROADMAP.md,
# queue 1)
_LATER = {
    "rna": "item 7 (RNA, --rna)",
    "dtw_std": "item 7 (--dtw-std)",
    "invert": "item 7 (--invert)",
    "secondary": "item 7 (--secondary)",
    "full_ref": "item 7 (--full-ref)",
    "from_end": "item 7 (--from-end)",
    "sam": "item 7 (--sam)",
    "pore": "item 7 (R10 and RNA004 chemistries)",
    "ref_chunk": "item 9 (chunked reference)",
    "host_stages": "item 10 (--host-stages device)",
    "mesh": "item 11 (multi-GPU mesh)",
}


def _later(what: str, option: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not served by this slice of the PyTorch/CUDA port; "
        f"ROADMAP.md queue 1 {_LATER[option]} brings it"
    )


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
    pore: str | None = None  # None = auto; only "r9" is served
    model_file: str | None = None
    debug_break: int = -1
    profile: bool = False
    ckpt: int = 512
    mesh: str | None = None
    host_stages: str = "host"
    # 0 = auto (one pass unless the reference needs the chunked path),
    # -1 = never chunk, > 0 = force chunks (not served yet)
    ref_chunk: int = 0
    device: str = "cuda"

    def check_slice(self) -> None:
        """Raise NotImplementedError for an option outside this slice."""
        for flag in ("rna", "dtw_std", "invert", "secondary", "full_ref",
                     "from_end", "sam"):
            if getattr(self, flag):
                raise _later("--" + flag.replace("_", "-"), flag)
        if self.prefix_size < 0:
            raise _later("-p -1 (query start autodetection)", "rna")
        if self.pore not in (None, "r9"):
            raise _later(f"--pore {self.pore}", "pore")
        if self.mesh:
            raise _later("--mesh", "mesh")
        if self.host_stages != "host":
            raise _later(f"--host-stages {self.host_stages}", "host_stages")
        if self.ref_chunk > 0:
            raise _later("--ref-chunk > 0", "ref_chunk")


@dataclass
class BatchStats:
    n_rec: int = 0
    sum_bytes: int = 0
    prefix_fail: int = 0
    ignored: int = 0
    too_short: int = 0


def _ref_meta(fasta_path: str, state: CoreState) -> RefSynth:
    """Contig names and lengths for output, from the FASTA, with the
    event-track lengths taken from a given state (DNA: L+1-k, offset 0)."""
    ref = RefSynth()
    for name, seq in read_fasta(fasta_path):
        ref.ref_names.append(name)
        ref.ref_seq_lengths.append(len(seq))
        ref.ref_st_offset.append(0)
        ref.num_ref += 1
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
        self.opt = opt
        opt.check_slice()
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
        elif exp == "rna":
            raise _later("RNA data (experiment_type rna)", "rna")
        elif exp != "genomic_dna":
            log_warning(f"Unknown experiment type: {exp}. Assuming genomic_dna")
        for g in range(1, self.sf.num_read_groups):
            curr = self.sf.header_get("experiment_type", g)
            if exp is not None and curr != exp:
                log_warning(
                    f"Experiment type mismatch: {curr} != {exp} in read "
                    f"group {g}. Defaulted to {exp}"
                )
        if opt.pore is None:
            kit = self.sf.header_get("sequencing_kit", 0)
            if kit is None:
                log_warning("sequencing_kit not found in SLOW5 header. Assuming R9.4.1")
            elif "114" in kit:
                raise _later("R10 data (sequencing_kit *114*)", "pore")
            elif "rna004" in kit:
                raise _later("RNA004 data (sequencing_kit *rna004*)", "pore")
            for g in range(1, self.sf.num_read_groups):
                curr = self.sf.header_get("sequencing_kit", g)
                if kit is not None and curr != kit:
                    log_warning(
                        f"sequencing_kit type mismatch: {curr} != {kit} in "
                        f"read group {g}. Defaulted to {kit}"
                    )

        # samples-per-event estimate for the prefix-bounded eventization
        # fast path (_prepare_read_prefix); EMA-refined from real reads
        self._dwell_ema = 10.0
        self._dwell_lock = threading.Lock()

        W = max(opt.query_size, 1)
        if state is None:
            # --- model
            if opt.model_file:
                model = read_model_tsv(opt.model_file)
            else:
                log_info("builtin DNA R9 nucleotide model loaded")
                model = load_builtin_model(MODEL_ID_DNA_R9)
            # --- synthesized reference
            self.ref: RefSynth = gen_ref(
                fasta_path, model, rna=False, query_size=opt.query_size
            )
            # --- device track layout: contig-major, '+' then '-' per
            # contig (candidate insertion order decides ties, ref
            # sigfish.c:870-964); every segment aligned to the query size
            # so the candidate windows are a static reshape
            tracks: list[np.ndarray] = []
            track_meta: list[tuple[int, str]] = []
            for j in range(self.ref.num_ref):
                tracks.append(self.ref.forward[j])
                track_meta.append((j, "+"))
                tracks.append(self.ref.reverse[j])
                track_meta.append((j, "-"))
            ref_cat, reset, offsets = pad_tracks(tracks, ckpt=opt.ckpt, align=W)
            state = core_state_from_numpy(
                model.level_mean, model.level_stdv, model.kmer_size,
                ref_cat, reset, offsets, [t.size for t in tracks], track_meta,
            )
        else:
            self.ref = _ref_meta(fasta_path, state)
        self.state = state
        self.ref_cat = state.ref_cat
        self.reset = state.reset
        self.track_offsets = state.offsets
        self.track_sizes = state.track_sizes
        self.track_meta = state.track_meta
        self.pad_q = max(128, ((opt.query_size + 127) // 128) * 128)
        if opt.ref_chunk == 0 and self.ref_cat.shape[0] + self.pad_q > CHUNK_AUTO_COLS:
            raise _later(
                f"a reference of {self.ref_cat.shape[0]} columns (past "
                f"{CHUNK_AUTO_COLS}, the chunked path's threshold)", "ref_chunk"
            )

        # static column maps for the candidate reduction, on the device
        u_map, valid_map = build_column_maps(
            self.track_offsets, self.ref_cat.shape[0], track_sizes=self.track_sizes
        )
        self.u_dev = torch.from_numpy(u_map).to(self.device)
        self.valid_dev = torch.from_numpy(valid_map).to(self.device)
        # wavefront reference buffers per Q, uploaded once per Core
        self._wf_cache: dict[int, tuple[torch.Tensor, torch.Tensor, int]] = {}

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

    def sdtw_candidates_collect(self, handle: dict) -> tuple[np.ndarray, np.ndarray]:
        """Wait for a submitted batch's results and unpack them."""
        if "parts" in handle:
            outs = [self.sdtw_candidates_collect(h) for h in handle["parts"]]
            return (
                np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]),
            )
        ts, tp = unpack_top5(_host_array(handle["packed"]))
        if "clip_packed" in handle:
            cs, cp = unpack_top5(_host_array(handle["clip_packed"]))
            rows = handle["clip_rows"]
            ts[rows] = cs
            tp[rows] = cp
        return ts, tp

    def _clip_pass(
        self, handle: dict, scores: torch.Tensor, qlens: np.ndarray, R: int, W: int
    ) -> None:
        """Second device pass for clipped reads (qlen != W): their
        diagonal-indexed `scores` rows hold their correct qlen-1 rows
        (shift_queries_for_clip lands them on the kernel's emitted lane
        W-1), so this only re-derives the qlen-wide candidate windows.
        The column slice is applied after the row take so only the
        clipped rows are materialized."""
        clip_rows = np.where((qlens > 0) & (qlens != W))[0]
        if not clip_rows.size:
            return
        rows_dev = torch.from_numpy(clip_rows).to(self.device)
        sub = scores.index_select(0, rows_dev)[:, W - 1 : W - 1 + R]
        qlens_dev = torch.from_numpy(qlens[clip_rows].astype(np.int32)).to(self.device)
        cpacked = topk_candidates(
            sub, qlens_dev, self.u_dev, self.valid_dev, R, k=5, reindex=False, pack=True,
        )
        handle["clip_rows"] = clip_rows
        handle["clip_packed"] = _start_host_copy(cpacked)

    def sdtw_candidates_submit(self, qb: np.ndarray, qlens: np.ndarray) -> dict:
        """Launch the device work for one query batch without waiting for
        it; returns a handle for sdtw_candidates_collect, so the caller
        can overlap the next batch's host stages with this batch's
        device time."""
        B, Q = qb.shape
        if B > self.DEVICE_CHUNK:
            C = self.DEVICE_CHUNK
            parts = [
                self.sdtw_candidates_submit(qb[o : o + C], qlens[o : o + C])
                for o in range(0, B, C)
            ]
            return dict(parts=parts)
        R = self.ref_cat.shape[0]
        W = self.opt.query_size
        ypad, rspad, _ = self._wavefront_inputs(Q)
        clip_rows = np.where((qlens > 0) & (qlens != W))[0]
        if clip_rows.size:
            # clipped reads ride the kernel's uniform emitted lane by
            # shifting their query up to end at lane W-1 (the free-start
            # lane moves with it via start_lanes)
            qb_k, fs_lanes = shift_queries_for_clip(qb, qlens, W - 1)
            fs_dev = torch.from_numpy(fs_lanes).to(self.device)
        else:
            qb_k, fs_dev = qb, None
        scores = sdtw_wavefront(
            torch.from_numpy(qb_k).to(self.device), ypad, rspad,
            lane=W - 1, start_lanes=fs_dev,
        )
        packed = window_top5(
            scores, self.valid_dev, R, W, k=5, reindex=True, pack=True
        )
        handle = dict(packed=_start_host_copy(packed))
        self._clip_pass(handle, scores, qlens, R, W)
        return handle

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
    query: np.ndarray | None = None  # z-scored slice
    pa: np.ndarray | None = None  # cached pA conversion (to_pa is pure)
    out: str | None = None
    skip: bool = False  # len_raw_signal==0 or ignored
    # per-read counter flags, tallied by the main thread (avoids races)
    flag_prefix_fail: bool = False
    flag_ignored: bool = False
    flag_too_short: bool = False


def _parse_single(core: Core, blob: bytes) -> ReadWork:
    """ref: parse_single sigfish.c:317-328."""
    w = ReadWork()
    w.rec = core.sf.decode_record(blob)
    if w.rec.len_raw_signal <= 0:
        w.skip = True
    return w


def _event_single(core: Core, w: ReadWork) -> ReadWork:
    """ref: event_single sigfish.c:330-378 (pA conversion + getevents)."""
    if w.skip:
        return w
    if w.pa is None:
        w.pa = w.rec.to_pa()
    et = get_events(w.pa, rna=False)
    w.event_start = et.start
    w.event_length = et.length
    w.event_mean = et.mean.copy()
    w.n_events = et.n
    if et.n <= 0:
        w.skip = True
    return w


def _normalise_single(core: Core, w: ReadWork) -> ReadWork:
    """ref: normalise_single sigfish.c:424-505 (query window + z-score),
    for DNA with a fixed prefix (-p >= 0) from the read's start."""
    if w.skip:
        return w
    opt = core.opt
    n = w.n_events
    start_idx = opt.prefix_size
    end_idx = start_idx + opt.query_size
    if start_idx + 25 > n:  # min query size 25, ref sigfish.c:450-456
        w.skip = True
        w.flag_ignored = True
        return w
    if end_idx > n:
        end_idx = n
        w.flag_too_short = True
    if end_idx <= start_idx:
        # empty query window (-q 0): counted as ignored, as the JAX
        # package does (PARITY.md Robustness)
        w.skip = True
        w.flag_ignored = True
        return w
    return _finish_normalise(core, w, int(start_idx), int(end_idx))


def _finish_normalise(core: Core, w: ReadWork, start_idx: int, end_idx: int) -> ReadWork:
    """Window z-score given the decided query window.

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
    w.query = sl_norm.copy()
    assert w.query.size == end_idx - start_idx
    return w


def _prepare_read_prefix(core: Core, w: ReadWork) -> ReadWork:
    """Prefix-bounded parse->events->normalise for one read.

    The query window only needs events up to qstart + query_size, and
    event detection is a causal left-to-right scan, so eventizing a
    grown signal PREFIX reproduces the leading events bit-exactly
    (ops/events.py detect_events_prefix safety contract). Falls back to
    the exact full-signal path for clipped/ignored reads or when no
    samples would be saved; the output is bit-identical to that path.
    """
    opt = core.opt
    if w.pa is None:
        w.pa = w.rec.to_pa()
    pa = w.pa
    n = pa.size
    w2 = DNA_PARAMS["window_length2"]
    q = opt.query_size
    if q <= 0:
        # empty query window; the exact path ignores such reads
        return _normalise_single(core, _event_single(core, w))
    need_past_start = max(q, 25)  # covers the ignored(<start+25) and
    # too_short(end>n) decisions: n_events >= start + max(q,25) forces
    # both checks to the not-clipped branch, matching the full run
    start_idx = opt.prefix_size

    # initial samples-per-event guess: per-Core EMA of the measured
    # density, margin 1.3; a short retry refines the bound from the
    # observed event table
    S = int((start_idx + need_past_start + 2) * core._dwell_ema * 1.3)
    S += 4 * w2 + 64
    for _ in range(4):
        if S >= n:
            break
        et, n_safe = get_events_prefix(pa[:S], False, S - w2)
        if n_safe >= 16:
            starts = et.start[:n_safe].astype(np.int64)
            needed = start_idx + need_past_start
            if n_safe >= needed:
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
                return _finish_normalise(core, w, start_idx, start_idx + q)
            # refine the bound from the observed local event density
            k = min(64, n_safe - 1)
            d_loc = float(starts[-1] - starts[-1 - k]) / k
            missing = needed - n_safe + 8
            S = int(starts[-1] + missing * d_loc * 1.3) + 4 * w2 + 64
        else:
            S *= 3
    # exact full-signal path
    return _normalise_single(core, _event_single(core, w))


def _prepare_read(core: Core, blob: bytes) -> ReadWork:
    """Fused parse + event + normalise for one read (default mode).

    ref: work_per_single_read sigfish.c:995-1001.
    """
    w = _parse_single(core, blob)
    if w.skip:
        return w
    return _prepare_read_prefix(core, w)


def _backtrack_best(core: Core, w: ReadWork, track_idx: int, pos_local: int) -> int:
    """Recover pos_st for the winner.

    Recomputes a fresh DP column window ending at the winning column and
    backtracks greedily -- exact because subsequence DTW has a free start
    on the reference axis. If the path touches the window's left edge
    the window is widened and recomputed. Replaces the reference's
    O(qlen x rlen) matrix retention (src/sigfish.c:873, src/cdtw.c:120).
    """
    from .. import native

    track_start = int(core.track_offsets[track_idx])
    pos_global = track_start + pos_local
    qlen = w.query.size
    span = min(max(2 * qlen, 64), pos_local + 1)
    while True:
        j_lo = pos_global + 1 - span
        ref_cols = core.ref_cat[j_lo : pos_global + 1]
        if native.available():
            px, py = native.subsequence_backtrack(w.query, ref_cols, span - 1, std=False)
        else:
            cost = subsequence_cost_seeded(w.query, ref_cols, None, std=False)
            px, py = subsequence_path(cost, span - 1)
        if py[0] == 0 and j_lo > track_start:
            # path touched the recompute window's left edge: widen
            span = min(span * 2, pos_local + 1)
            continue
        break
    return int(py[0]) + (j_lo - track_start)


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


def _pool_map(pool, fn, items, chunk: int = 32):
    """Order-preserving parallel map in chunks: one future per ~chunk
    items instead of one per item."""
    items = list(items)
    if pool is None or len(items) <= chunk:
        return [fn(x) for x in items]
    slices = [items[i : i + chunk] for i in range(0, len(items), chunk)]
    out = pool.map(lambda sl: [fn(x) for x in sl], slices)
    return [y for ch in out for y in ch]


def submit_batch(core: Core, blobs: list[bytes]) -> PendingBatch:
    """Host stages + asynchronous device launch for one batch of raw records."""
    opt = core.opt
    stats = BatchStats(n_rec=len(blobs), sum_bytes=sum(len(b) for b in blobs))

    # ---- host stages (parallel over reads); --profile-cpu runs them
    # stage-by-stage with per-stage wall-clock accumulation
    # (ref: process_db sigfish.c:1021-1042)
    def _map(fn, items):
        return _pool_map(core._pool, fn, items)

    if opt.profile:
        t0 = time.time()
        works = _map(lambda b: _parse_single(core, b), blobs)
        core.parse_time += time.time() - t0
        t0 = time.time()
        works = _map(lambda w: _event_single(core, w), works)
        core.event_time += time.time() - t0
        t0 = time.time()
        works = _map(lambda w: _normalise_single(core, w), works)
        core.normalise_time += time.time() - t0
    else:
        works = _map(lambda b: _prepare_read(core, b), blobs)
    dtw_t0 = time.time()

    for w in works:
        stats.prefix_fail += w.flag_prefix_fail
        stats.ignored += w.flag_ignored
        stats.too_short += w.flag_too_short

    live = [i for i, w in enumerate(works) if not w.skip]
    pending = PendingBatch(works=works, stats=stats, live=live, dtw_t0=dtw_t0)
    if not live:
        return pending

    # ---- device stage: pad the batch to a 64 / power-of-two bucket
    queries = [works[i].query for i in live]
    nb = len(queries)
    bucket = 64
    while bucket < nb:
        bucket *= 2
    bucket = min(bucket, max(64, opt.batch_size))
    while len(queries) < bucket:
        # dummy slots carry a full-width zero query so they ride the
        # uniform candidate path (their results are never read)
        queries.append(np.zeros(max(opt.query_size, 1), dtype=np.float32))
    qb, qlens, _ = make_query_batch(queries, pad_q=core.pad_q)
    pending.handle = core.sdtw_candidates_submit(qb, qlens)
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
    top_s, top_p = core.sdtw_candidates_collect(pending.handle)

    # pass 1: winner selection per read (cheap host work)
    winners = []  # (w, t, pos_end_local, d1, d2, rid, strand)
    for slot, i in enumerate(live):
        w = works[i]
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
        rid, strand = core.track_meta[t]
        pos_end_local = pos_global - int(offs[t])
        winners.append((w, t, pos_end_local, d1, d2, rid, strand))

    # pass 2: winner backtracks (native calls release the GIL -> the
    # thread pool parallelizes them on multi-core hosts)
    starts = _pool_map(
        core._pool, lambda a: _backtrack_best(core, a[0], a[1], a[2]), winners
    )

    # pass 3: coordinates + formatting
    for (w, t, pos_end_local, d1, d2, rid, strand), pos_st_local in zip(winners, starts):
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

    drainer = _fut.ThreadPoolExecutor(max_workers=1)  # ordered drains
    drain_fut: _fut.Future | None = None
    pending: PendingBatch | None = None
    done = False
    try:
        while not done:
            if pending is not None and not opt.profile:
                # start batch N's drain BEFORE batch N+1's load AND host
                # stages
                drain_fut = drainer.submit(drain, pending)
                pending = None
            t0 = time.time()
            blobs = core.sf.read_batch(opt.batch_size, opt.batch_size_bytes)
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
