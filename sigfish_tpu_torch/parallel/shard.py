"""Multi-GPU execution over a (dp, tp) grid of devices, in one process.

The port of sigfish_tpu/parallel/shard.py's two production engines, as
the JAX Core runs them (one process over local devices):

  dp (data parallel)   the read batch splits over the grid's rows.
  tp (track parallel)  tracks mode (sharded_topk): whole tracks split over
                       the grid's columns, a contiguous balanced split
                       (shard_tracks). Each shard runs the one-shot
                       wavefront kernel over its tracks and reduces its
                       last row to two top-k lists; the (B/dp, 4k)
                       payloads meet on the row's first device and
                       merge exactly (merge_gathered_topk).
  tp ring              ring mode (ring_topk), for fewer tracks than
                       shards: the layout splits by columns, and the
                       carry kernel's state runs from shard to shard,
                       microbatch by microbatch. Each shard folds its
                       columns into per-window accumulators (ShardFold),
                       and the (B, 2k+4) payloads merge with the windows
                       split at shard boundaries re-joined.

What shard_map's collectives become here:

  all_gather over tp   torch.cat of the shards' payloads on the first
                       device of the grid's row
  ppermute of a carry  the four carry tensors .to(the next shard's device)

On the card each shard works on a stream of its own (shard_streams), so
one card listed n times runs the shards' work side by side, with the
same cross-stream ordering that n cards need. Every hand-off between
shards, a carry or a payload, waits on an event recorded on the
producer's stream (hand_off); none relies on the order of a shared
stream. On the CPU there are no streams and the work runs in order.

Both modes run either engine of the JAX module: the wavefront kernels
(the default, --engine pallas) or the column scan (--engine scan, and
--engine native with a mesh, as in the JAX Core): sharded_topk(...,
scan=True) is sharded_engine_topk's scan branch, ring_topk_scan the JAX
package's ring_topk_scan, the carry column (B / n_micro, Q) handed from
shard to shard. The JAX module's dry-run helpers and full-row oracles
(sharded_sdtw, sharded_sdtw_step, ring_fullref_lastrow,
ring_fullref_lastrow_wavefront) are not ported: no route runs them, and
the engines here are held to the JAX package's top-k engines directly.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..ops.candidates_dev import (
    BIG,
    _pack,
    merge_gathered_topk,
    select_topk_cands,
    topk_candidates,
    window_top5,
)
from ..ops.chunked_ref import CHUNK_AUTO_COLS, ShardFold
from ..ops.sdtw_scan import onehot_rows, sdtw_scan
from ..ops.sdtw_wavefront import carry_fresh_state, sdtw_wavefront, sdtw_wavefront_carry


def make_mesh(n_dp: int, n_tp: int = 1, devices=None) -> list[list[torch.device]]:
    """A (dp, tp) grid, as rows of torch.devices, of the first n_dp*n_tp
    devices: devices=None takes the CUDA devices torch sees."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    need = n_dp * n_tp
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    devs = [torch.device(d) for d in devices[:need]]
    return [devs[i * n_tp : (i + 1) * n_tp] for i in range(n_dp)]


def shard_streams(mesh: list[list[torch.device]]) -> list[list]:
    """A new stream for each CUDA shard of the grid, None for a CPU one."""
    return [[torch.cuda.Stream(d) if d.type == "cuda" else None for d in row] for row in mesh]


def shard_tracks(
    tracks: list[np.ndarray], n_tp: int, ckpt: int = 512, align: int = 1
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[list[int]]]:
    """Partition whole tracks across n_tp shards (contiguous balanced
    split), each shard padded to the common per-shard width.

    With align > 1 every track segment inside a shard starts at an align
    multiple and the per-shard width Rs is an align multiple too, so the
    gathered (n_tp*Rs) concatenation keeps every track W-aligned -- the
    on-device candidate window reshape (ops/candidates_dev.py) then works
    unchanged on the gathered score matrix.

    Returns (ref (n_tp, Rs) f32, reset (n_tp, Rs) bool,
    offsets (n_tp, T_max+1) i64 local track offsets per shard,
    assignment: per-shard list of global track indices).
    """
    def seg(sz: int) -> int:
        return ((sz + align - 1) // align) * align if align > 1 else sz

    # contiguous balanced partition (NOT bin-packing): the gathered
    # column order must equal the original track order, because candidate
    # ties resolve by insertion order (update_aln sigfish.c:577-583)
    sizes = [seg(t.size) for t in tracks]
    total = max(sum(sizes), 1)
    assign: list[list[int]] = [[] for _ in range(n_tp)]
    loads = [0] * n_tp
    cum = 0
    for gi, sz in enumerate(sizes):
        s = min(n_tp - 1, n_tp * (2 * cum + sz) // (2 * total))
        assign[s].append(gi)
        loads[s] += sz
        cum += sz
    width = max(loads) if max(loads) else ckpt
    # Rs must be a multiple of both ckpt (scan chunking) and align
    # (window alignment across gathered shard boundaries)
    unit = ckpt * align // math.gcd(ckpt, align) if align > 1 else ckpt
    Rs = ((width + unit - 1) // unit) * unit
    ref = np.full((n_tp, Rs), 1.0e18, dtype=np.float32)
    reset = np.zeros((n_tp, Rs), dtype=bool)
    tmax = max(len(a) for a in assign)
    offsets = np.zeros((n_tp, tmax + 1), dtype=np.int64)
    for s, a in enumerate(assign):
        pos = 0
        for li, gi in enumerate(a):
            t = tracks[gi]
            ref[s, pos : pos + t.size] = t
            if t.size:
                reset[s, pos] = True
            if t.size < seg(t.size):
                reset[s, pos + t.size] = True  # intra-shard pad gap
            pos += seg(t.size)
            offsets[s, li + 1] = pos
        offsets[s, len(a) + 1 :] = pos
        if pos < Rs:
            reset[s, pos] = True  # padding is its own track
    return ref, reset, offsets, assign


def ring_shape(R: int, n_tp: int, unit: int, ref_chunk: int = 0) -> tuple[int, int]:
    """The ring layout's shard width Rs and sub-chunks per shard n_sub,
    by the JAX Core's rule: R columns (the layout and the flush
    diagonals after it) over n_tp shards, Rs a multiple of `unit`; n_sub
    the divisor of Rs / unit whose sub-chunk Rs / n_sub lies nearest to
    ref_chunk > 0 or, with ref_chunk 0 once Rs passes CHUNK_AUTO_COLS, to
    CHUNK_AUTO_COLS (the smaller divisor wins ties); else 1."""
    per = -(-R // n_tp)
    Rs = ((per + unit - 1) // unit) * unit
    n_sub = 1
    if ref_chunk > 0 or (ref_chunk == 0 and Rs > CHUNK_AUTO_COLS):
        target = ref_chunk if ref_chunk > 0 else CHUNK_AUTO_COLS
        m_units = Rs // unit
        for d in range(1, m_units + 1):
            if m_units % d == 0 and abs(Rs // d - target) < abs(Rs // n_sub - target):
                n_sub = d
    return Rs, n_sub


@contextlib.contextmanager
def _on(dev: torch.device, stream):
    """Queue the block's device work on a shard's stream (None: the CPU,
    as it is), behind what dev's current stream has queued: the Core's
    buffers and the previous batch."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        yield


def hand_off(ts: list[torch.Tensor], src_stream, device: torch.device, dst_stream) -> list:
    """Tensors made on src_stream, as tensors on `device` for dst_stream
    to read: on the same device read in place, else copied on src_stream
    (PyTorch's two-way barrier for a copy between devices then ties it
    to the destination's current stream, not to dst_stream, so the
    source shard never waits on the next shard's queued work); then
    dst_stream waits on an event recorded on src_stream after the copy.
    Each result goes back to the allocator only once dst_stream is done
    with it. On the CPU: .to(device)."""
    if src_stream is None:
        return [t.to(device) for t in ts]
    with torch.cuda.stream(src_stream):
        out = [t.to(device, non_blocking=True) for t in ts]
    ev = torch.cuda.Event()
    ev.record(src_stream)
    dst_stream.wait_event(ev)
    for o in out:
        o.record_stream(dst_stream)
    return out


def _gather(payloads: list[torch.Tensor], streams: list, dev: torch.device) -> torch.Tensor:
    """The shards' payloads side by side on dev, for its current stream:
    the all_gather over tp."""
    main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    return torch.cat(
        [hand_off([p], st, dev, main)[0] for p, st in zip(payloads, streams)], dim=1
    )


def _globalize(tp: torch.Tensor, off: int) -> torch.Tensor:
    return torch.where(tp >= 0, tp + off, tp)


def sharded_topk(
    queries: np.ndarray,   # (B, Q) f32 (wavefront: through shift_queries_for_clip); B a multiple of n_dp
    qlens: np.ndarray,     # (B,) i32
    bufs: list[list[tuple]],
    mesh: list[list[torch.device]],
    streams: list[list],
    Rs: int,
    lane: int,
    k: int = 5,
    scan: bool = False,
) -> list[torch.Tensor]:
    """The tracks engine: the JAX package's sharded_engine_topk, on its
    wavefront branch with clip_shift or, with scan=True, on its scan
    branch.

    bufs[i][s]: shard s's (ypad (1, D), rspad (1, D), u (Rs,) i32, valid
    (Rs,) bool) on mesh[i][s], in shard_tracks' layout; with scan=True
    (ref (Rs,) f32, reset (Rs,) bool, u, valid). streams:
    shard_streams(mesh). Grid row i takes rows [i*B/n_dp, (i+1)*B/n_dp).
    Each shard runs the one-shot kernel (clipped reads from their start
    lanes W - qlen) and slices the last row [lane, lane + Rs), or runs the
    scan over its columns (the unshifted queries, each row's last row
    picked at qlen - 1), reduces it to the W-window top-k (window_top5)
    and the per-read-window top-k (topk_candidates), and makes the
    positions global (+ s * Rs). Returns one packed (B / n_dp, 4k) tensor
    per grid row, on the row's first device: [:, :2k] serves full-length
    reads, [:, 2k:] clipped ones."""
    n_dp, n_tp = len(mesh), len(mesh[0])
    Bd = queries.shape[0] // n_dp
    W = lane + 1
    outs = []
    for i in range(n_dp):
        q_h = np.ascontiguousarray(queries[i * Bd : (i + 1) * Bd])
        ql_h = np.ascontiguousarray(qlens[i * Bd : (i + 1) * Bd], dtype=np.int32)
        sl_h = np.where((ql_h > 0) & (ql_h < W), W - ql_h, 0).astype(np.int32)
        payloads = []
        for s in range(n_tp):
            dev = mesh[i][s]
            yp, rp, u, valid = bufs[i][s]
            with _on(dev, streams[i][s]):
                q = torch.from_numpy(q_h).to(dev)
                ql = torch.from_numpy(ql_h).to(dev)
                if scan:
                    lr, _ = sdtw_scan(q, onehot_rows(ql, q.shape[1], dev), yp, rp)
                else:
                    sl = torch.from_numpy(sl_h).to(dev) if sl_h.any() else None
                    lr = sdtw_wavefront(q, yp, rp, lane, start_lanes=sl)[:, lane : lane + Rs]
                ts_m, tp_m = window_top5(lr, valid, Rs, W, k, reindex=False)
                ts_c, tp_c = topk_candidates(lr, ql, u, valid, Rs, k, reindex=False)
                payloads.append(torch.cat(
                    [_pack(ts_m, _globalize(tp_m, s * Rs)), _pack(ts_c, _globalize(tp_c, s * Rs))],
                    dim=1,
                ))
        g = _gather(payloads, streams[i], mesh[i][0]).reshape(Bd, n_tp, 4 * k)
        halves = [
            merge_gathered_topk(g[:, :, h : h + 2 * k].reshape(Bd, n_tp * 2 * k), n_tp, k)
            for h in (0, 2 * k)
        ]
        outs.append(torch.cat(halves, dim=1))
    return outs


def _ring_payload(wmin: torch.Tensor, wpos: torch.Tensor, k: int) -> torch.Tensor:
    """A shard's (B, 2k+4) payload from its (B, nw_s) shard frame
    (ShardFold.frame): the top-k of its whole windows (slots 1 ..
    nw_s-2), then slot 0's and slot nw_s-1's (min, position), the
    partial windows it shares with the shards before and after."""
    B, nw_s = wmin.shape
    if nw_s > 2:
        ts, tp = select_topk_cands(wmin[:, 1 : nw_s - 1], wpos[:, 1 : nw_s - 1], k)
    else:  # degenerate shard width (Rs == W): only boundary windows
        ts = torch.full((B, k), BIG, dtype=torch.float32, device=wmin.device)
        tp = torch.full((B, k), -1, dtype=torch.int32, device=wmin.device)
    return torch.cat([_pack(ts, tp), _pack(wmin[:, :1], wpos[:, :1]),
                      _pack(wmin[:, nw_s - 1 :], wpos[:, nw_s - 1 :])], dim=1)


def _ring_extract_merge(gathered: torch.Tensor, n_tp: int, k: int) -> torch.Tensor:
    """The global packed (B, 2k) from the shards' gathered payloads (B,
    n_tp * (2k+4)): the window split between shards s and s+1 is shard
    s's last partial merged with shard s+1's first, by strict < (the
    earlier shard's partial wins ties: first-min-wins, sigfish.c:895);
    the last shard's trailing window has no later part. Then the same
    selection as the tracks mode's merge."""
    B = gathered.shape[0]
    gb = gathered.reshape(B, n_tp, 2 * k + 4)

    def ints(a):
        return a.contiguous().view(torch.int32)

    sc5 = gb[:, :, :k].reshape(B, n_tp * k)
    pp5 = ints(gb[:, :, k : 2 * k]).reshape(B, n_tp * k)
    m0, p0 = gb[:, :, 2 * k], ints(gb[:, :, 2 * k + 1])
    mL, pL = gb[:, :, 2 * k + 2], ints(gb[:, :, 2 * k + 3])
    m0n = torch.cat([m0[:, 1:], torch.full((B, 1), BIG, device=gb.device)], dim=1)
    p0n = torch.cat([p0[:, 1:], torch.full((B, 1), -1, dtype=torch.int32, device=gb.device)],
                    dim=1)
    take = m0n < mL  # strict: the earlier shard wins ties
    bm = torch.where(take, m0n, mL)
    bp = torch.where(take, p0n, pL)
    return _pack(*select_topk_cands(torch.cat([sc5, bm], 1), torch.cat([pp5, bp], 1), k))


def _ring_run(
    devices: list[torch.device],
    streams: list,
    B: int,
    n_micro: int,
    k: int,
    upload,
    step,
) -> torch.Tensor:
    """The ring's microbatch pipeline, shared by both engines.

    upload(s) puts the batch's inputs on devices[s]; step(s, m, rows, up,
    carry) runs microbatch m (rows of the batch) on shard s from the
    carry shard s-1 handed on for it (None on shard 0) and returns its
    shard frame (wmin, wpos) and its outgoing carry, a list of tensors.
    Both run on shard s's stream. At step t shard s runs microbatch t - s,
    so on distinct cards shard s+1 works on microbatch m-1 while shard s
    works on m; each carry reaches the next shard through hand_off.
    Returns the packed (B, 2k) on devices[0]."""
    n_tp = len(devices)
    Bm = B // n_micro
    ups = []
    for s in range(n_tp):
        with _on(devices[s], streams[s]):
            ups.append(upload(s))
    frames = [[None] * n_micro for _ in range(n_tp)]
    incoming = {}
    for t in range(n_micro + n_tp - 1):
        # shards from the last one: a hand-off to shard s+1 then queues
        # behind that shard's work of this step, not ahead of it
        for s in reversed(range(n_tp)):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            with _on(devices[s], streams[s]):
                frames[s][m], carry = step(s, m, slice(m * Bm, (m + 1) * Bm), ups[s],
                                           incoming.pop((s, m), None))
            if s + 1 < n_tp:
                incoming[(s + 1, m)] = hand_off(carry, streams[s], devices[s + 1],
                                                streams[s + 1])
    payloads = []
    for s in range(n_tp):
        with _on(devices[s], streams[s]):
            wmin = torch.cat([f[0] for f in frames[s]])
            wpos = torch.cat([f[1] for f in frames[s]])
            payloads.append(_ring_payload(wmin, wpos, k))
    return _ring_extract_merge(_gather(payloads, streams, devices[0]), n_tp, k)


def ring_topk(
    queries: np.ndarray,      # (B, Q) f32 through shift_queries_for_clip
    start_lanes: np.ndarray,  # (B,) i32
    bufs: list[tuple],
    devices: list[torch.device],
    streams: list,
    n_micro: int,
    lane: int,
    W: int,
    Rs: int,
    k: int = 5,
) -> torch.Tensor:
    """The ring engine: the JAX package's ring_topk_wavefront.

    bufs[s]: shard s's (ypad_seg, rspad_seg (n_sub, 1, Ds), vdiag_seg
    (n_sub, Ds)) on devices[s], its columns [s*Rs, (s+1)*Rs) of the ring
    layout in n_sub sub-chunks of Ds diagonals (vdiag: the layout's valid
    mask moved up by lane, as the kernel emits column c at diagonal c +
    lane); streams: one per shard (shard_streams).

    The batch runs as n_micro microbatches of B / n_micro rows through
    _ring_run: shard s runs a microbatch through its sub-chunks, each one
    carry launch folded into the shard's ShardFold, from a fresh state on
    shard 0, from shard s-1's outgoing state for the same microbatch
    otherwise. The launches with every start lane 0 take none (the
    kernel's faster instance, the same scores). Returns the packed (B,
    2k) on devices[0]."""
    B, Q = queries.shape
    Bm = B // n_micro
    clipped = [bool(start_lanes[m * Bm : (m + 1) * Bm].any()) for m in range(n_micro)]

    def upload(s):
        return (torch.from_numpy(np.ascontiguousarray(queries)).to(devices[s]),
                torch.from_numpy(start_lanes.astype(np.int32)).to(devices[s]))

    def step(s, m, rows, up, state):
        yps, rps, vds = bufs[s]
        qm = up[0][rows]
        fsm = up[1][rows] if clipped[m] else None
        if state is None:
            state = carry_fresh_state(Bm, Q, devices[s])
        fold = ShardFold(Bm, vds, W, s * Rs)
        for c in range(yps.shape[0]):
            o, *state = sdtw_wavefront_carry(qm, yps[c], rps[c], *state, lane, start_lanes=fsm)
            fold.update(c, o)
        return fold.frame(), state

    return _ring_run(devices, streams, B, n_micro, k, upload, step)


def ring_topk_scan(
    queries: np.ndarray,      # (B, Q) f32, unshifted
    qlens: np.ndarray,        # (B,) i32
    bufs: list[tuple],
    devices: list[torch.device],
    streams: list,
    n_micro: int,
    W: int,
    Rs: int,
    k: int = 5,
) -> torch.Tensor:
    """The ring engine on the column scan: the JAX package's
    ring_topk_scan.

    bufs[s]: shard s's (ref (Rs,) f32, reset (Rs,) bool, valid (Rs,)
    bool), its columns [s*Rs, (s+1)*Rs) of the ring layout (Rs a multiple
    of W); streams: one per shard (shard_streams). The same microbatch
    pipeline as ring_topk (_ring_run): shard s scans a microbatch over its
    columns, from a BIG column on shard 0, from the final column (B /
    n_micro, Q) that shard s-1 handed on for the same microbatch
    otherwise. The row is column-indexed, so each of the shard's Rs / W
    windows is whole: its frame's slot 0 stays empty and its last window
    meets the next shard's empty slot 0 in _ring_extract_merge. Each
    row's last row is picked at qlen - 1, so clipped rows get theirs
    (their per-read windows are the caller's). Returns the packed (B,
    2k) on devices[0]."""
    B, Q = queries.shape
    Bm = B // n_micro
    nw = Rs // W

    def upload(s):
        return (torch.from_numpy(np.ascontiguousarray(queries)).to(devices[s]),
                onehot_rows(qlens, Q, devices[s]))

    def step(s, m, rows, up, carry):
        dev = devices[s]
        ref, reset, valid = bufs[s]
        init = None if carry is None else carry[0]
        lr, col = sdtw_scan(up[0][rows], up[1][rows], ref, reset, init=init)
        wsc = torch.where(valid[None, :], lr, BIG).reshape(Bm, nw, W)
        amin = torch.argmin(wsc, dim=2)  # the first minimum wins
        pmin = wsc.gather(2, amin[:, :, None])[:, :, 0]
        ppos = (s * Rs + torch.arange(nw, dtype=torch.int32, device=dev)[None, :] * W
                + amin.to(torch.int32))
        frame = (torch.cat([torch.full((Bm, 1), BIG, device=dev), pmin], dim=1),
                 torch.cat([torch.full((Bm, 1), -1, dtype=torch.int32, device=dev), ppos], dim=1))
        return frame, [col]

    return _ring_run(devices, streams, B, n_micro, k, upload, step)
