"""Chunked-reference wavefront sDTW: bounded device memory for
multi-megabase references on one GPU.

The port of sigfish_tpu/ops/chunked_ref.py. The one-shot path holds the
kernel's whole diagonal-indexed score buffer (B, D) before the window
top-5: at B=512 over both strands of a 4.6 Mb genome (9.3M columns) that
is 19 GB, and the top-5 copies it twice more. This path runs the carry
mode of the wavefront kernel (ops/sdtw_wavefront.sdtw_wavefront_carry)
over reference segments, one launch each (carry_chain), and hands each
segment's scores to folds that keep a running per-window (min, first
position) accumulator, so the device holds

    O(B * Ds)    one segment's scores (Ds ~ 32k diagonals)
  + O(B * G)     the window accumulators, G ~ R / qlen windows
  + O(B * Q)     the DP carry

Exactness (that of the JAX package, kept rule for rule):

  - the carry chain is bit-identical to one kernel call over the
    concatenation, and the diagonal-indexed emission is the column-
    indexed last row shifted by W-1, so segment s covers columns
    [s*Ds - (W-1), (s+1)*Ds - (W-1)) verbatim;
  - windows of width W are aligned to multiples of W (pad_tracks with
    align=W), so a left pad of p = (-(W-1)) % W columns puts every
    segment on the window grid, splitting one window per boundary;
    window 0 of the accumulator is a guard that absorbs the columns
    below 0 (WindowFold);
  - within a window the first minimum wins (torch.argmin), and the two
    parts of a split window merge with strict `<`, so the EARLIER part
    wins ties: the reference's first-min-wins window scan
    (sigfish.c:895);
  - the final top-5 over the folded windows is window_top5's
    latest-window-wins selection (candidates_dev._select_latest_min).

Clipped reads (qlen != W) ride the same chain: shifted by
layout.shift_queries_for_clip, with their start lanes on every launch,
their column c sits at diagonal c + W - 1 as a full-length read's does.
Their windows are per read and per track (ClipFold): window (t, j) of
read b holds the columns of track t whose local index u has u // qlen_b
== j. qlen_b < W <= Ds, so a window spans at most two segments, and the
same strict `<` merge keeps the earlier part's first minimum. The result
is topk_candidates(reindex=False) over the one-shot row, bit for bit.

--dtw-std runs the same chain with std=True, and CornerFold gathers
each track's corner (the emitted row at the track's last column) from
the segment that holds it: the one-shot corners, bit for bit, with no
(B, D) buffer and no host DP at any reference size.

The segment loop is on the host: segment offsets are Python ints, and
the launches queue on one stream, each seeing the previous one's state.
The accumulators are updated in place. A segment that flag_free_segments
finds without a reset flag (all but the few that hold a track start or
the PAD flush, or see one in their incoming window) runs the carry
kernel's flag-free body (sdtw_wavefront_carry(..., flags=False)).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .candidates_dev import BIG, _pack, _select_latest_min
from .layout import PAD
from .sdtw_wavefront import carry_body, carry_fresh_state, carry_warps, sdtw_wavefront_carry

# chunk once the diagonal-indexed score buffer would pass this many
# columns (the JAX package's threshold; 4*B*D bytes at B=512 is 2 GB)
CHUNK_AUTO_COLS = 1 << 20

# the CUDA kernel's diagonal tile: a segment length that is a multiple of
# it keeps every launch's tiles whole
DIAG_TILE = 32

# ClipFold's "no column yet" position: above every column index
_NO_COL = int(np.iinfo(np.int32).max)


def chunk_segment_diags(W: int, target: int = 32768, unit: int = DIAG_TILE) -> int:
    """Segment length Ds: a multiple of W (the window grid) and of
    `unit` (the kernel's diagonal tile), near `target` diagonals. At
    W=250 and the default target it is 32,000."""
    lcm = W * unit // math.gcd(W, unit)
    return max(1, round(target / lcm)) * lcm


def prepare_chunked_inputs(
    ref: np.ndarray,
    reset: np.ndarray,
    valid: np.ndarray,
    Q: int,
    W: int,
    target: int = 32768,
):
    """Host-side segment prep for carry_chain and its folds.

    ref/reset: the pad_tracks(align=W) concatenation (R,) and its track-
    start flags; valid: (R,) bool real-column mask (build_column_maps).
    Returns (ypad_seg (S, 1, Ds) f32, rspad_seg (S, 1, Ds) f32,
    valid_seg (S, Ds) bool, Ds, nwin_tot)."""
    R = ref.shape[0]
    Ds = chunk_segment_diags(W, target)
    D = ((R + Q + Ds - 1) // Ds) * Ds
    S = D // Ds
    ypad = np.full(D, PAD, dtype=np.float32)
    ypad[:R] = ref
    rspad = np.zeros(D, dtype=np.float32)
    rspad[:R] = reset.astype(np.float32)
    assert R < D, "need Q >= 1 so the kernel has a PAD tail to flush into"
    rspad[R] = 1.0
    # segment s's diagonal t is column s*Ds + t - (W-1); columns outside
    # [0, R) are invalid (the first W-1 diagonals are partial-DP garbage,
    # the tail is the PAD flush)
    vext = np.zeros(D, dtype=bool)
    vext[W - 1 : W - 1 + R] = valid
    return (
        ypad.reshape(S, 1, Ds),
        rspad.reshape(S, 1, Ds),
        vext.reshape(S, Ds),
        Ds,
        (R + W - 1) // W,
    )


def flag_free_segments(rspad_seg: np.ndarray, Q: int) -> np.ndarray:
    """(S,) bool: segment s has no reset flag set in its own diagonals
    nor in the Q-1 columns before them, which its incoming window holds
    and its rows read (the fresh state's window before segment 0 holds
    none), so its carry launch may take flags=False. rspad_seg: (S, 1,
    Ds) as prepare_chunked_inputs gives it."""
    S, _, Ds = rspad_seg.shape
    flags = rspad_seg.reshape(S * Ds) > 0.5
    # prefix counts of set flags: segment s reads [s*Ds - (Q-1), (s+1)*Ds)
    cum = np.concatenate([[0], np.cumsum(flags, dtype=np.int64)])
    lo = np.maximum(np.arange(S) * Ds - (Q - 1), 0)
    hi = np.arange(1, S + 1) * Ds
    return cum[hi] == cum[lo]


def prepare_clip_inputs(
    offsets: np.ndarray, track_sizes: list[int], W: int, S: int, Ds: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side segment prep for ClipFold, in prepare_chunked_inputs'
    diagonal layout: for every diagonal of every segment, the track of
    its column and the column's index inside that track, both (S, Ds)
    i32. Diagonals whose column is no real column hold 0 (valid_seg
    masks them)."""
    track = np.zeros(S * Ds, dtype=np.int32)
    local = np.zeros(S * Ds, dtype=np.int32)
    for t, size in enumerate(track_sizes):
        lo = int(offsets[t]) + W - 1
        track[lo : lo + size] = t
        local[lo : lo + size] = np.arange(size, dtype=np.int32)
    return track.reshape(S, Ds), local.reshape(S, Ds)


def clip_window_bases(
    track_sizes: list[int], qlens: np.ndarray, cache: dict | None = None
) -> tuple[np.ndarray, int]:
    """The window numbering of ClipFold. Read b's real windows are (track
    t, j = u // qlen_b) in column order; track t has ceil(len_t / qlen_b)
    of them (its last, shorter window is real), so window (t, j) is
    number bases[b, t] + j. Returns (bases (B, T) i64, the most real
    windows of any read). `cache`, a dict by qlen, keeps each qlen's
    numbering across calls."""
    cache = {} if cache is None else cache
    sizes = np.asarray(track_sizes, dtype=np.int64)
    rows, most = [], 0
    for q in np.asarray(qlens).tolist():
        if q not in cache:
            n = -(-sizes // q)
            cache[q] = (np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64), int(n.sum()))
        base, n_win = cache[q]
        rows.append(base)
        most = max(most, n_win)
    return np.stack(rows), most


class WindowFold:
    """The W-window fold of full-length rows: every row's windows of
    width W on the pad_tracks(align=W) grid, folded segment by segment
    into a (B, G) running (min, first position)."""

    def __init__(self, B: int, valid_seg: torch.Tensor, W: int, nwin_tot: int):
        S, Ds = valid_seg.shape
        if Ds % W:
            raise ValueError(f"segment length {Ds} is not a multiple of W={W}")
        dev = valid_seg.device
        self.valid_seg, self.W, self.Ds, self.nwin_tot = valid_seg, W, Ds, nwin_tot
        self.p = (-(W - 1)) % W                 # left pad to the window grid (1 for W > 1)
        self.nw_c = (self.p + Ds + W - 1) // W  # windows a segment touches
        self.G = S * (Ds // W) + 2              # window 0 is the guard for columns < 0
        self.wmin = torch.full((B, self.G), BIG, dtype=torch.float32, device=dev)
        self.wpos = torch.full((B, self.G), -1, dtype=torch.int32, device=dev)
        self.widx = torch.arange(self.nw_c, dtype=torch.int32, device=dev) * W

    def update(self, s: int, scores: torch.Tensor) -> None:
        """Fold segment s's (B, Ds) scores."""
        W, Ds, p, nw_c = self.W, self.Ds, self.p, self.nw_c
        B = scores.shape[0]
        block = torch.where(self.valid_seg[s][None, :], scores, BIG)
        if p or nw_c * W != p + Ds:
            block = torch.nn.functional.pad(block, (p, nw_c * W - Ds - p), value=BIG)
        wsc = block.reshape(B, nw_c, W)
        amin = torch.argmin(wsc, dim=2)  # first minimum wins (sigfish.c:895)
        pmin = wsc.gather(2, amin[:, :, None])[:, :, 0]
        col0 = s * Ds - (W - 1) - p      # column of the segment block's first slot
        ppos = (self.widx + col0)[None, :] + amin.to(torch.int32)
        gw0 = col0 // W + 1              # floor division, as the JAX package's
        assert 0 <= gw0 and gw0 + nw_c <= self.G, (gw0, nw_c, self.G)
        cur_m = self.wmin[:, gw0 : gw0 + nw_c]
        cur_p = self.wpos[:, gw0 : gw0 + nw_c]
        # strict <: the EARLIER segment's part of a split window wins ties
        take = pmin < cur_m
        cur_p.copy_(torch.where(take, ppos, cur_p))
        cur_m.copy_(torch.where(take, pmin, cur_m))

    def top5(self, k: int = 5) -> torch.Tensor:
        """The packed (B, 2k) buffer of window_top5(pack=True)."""
        ts, pick = _select_latest_min(self.wmin[:, 1 : 1 + self.nwin_tot], k)
        tp = self.wpos[:, 1 : 1 + self.nwin_tot].gather(1, pick)
        tp = torch.where(ts >= BIG, -1, tp)
        return _pack(ts, tp)


class ShardFold(WindowFold):
    """The ring's per-shard fold (the JAX package's ring_topk_wavefront,
    its `sub`): a WindowFold over one shard's n_sub sub-chunks, whose
    first diagonal is the shard's column col_off = s * Rs. WindowFold's
    arithmetic numbers the sub-chunk's windows from column c * Ds - (W-1)
    - p of the shard, so its first nw_s = Rs / W + 1 slots are the JAX
    package's shard frame: slot w holds window s * Rs / W - 1 + w, and
    slots 0 and nw_s - 1 are the partial windows split with the shard
    before and after. valid_seg: the shard's (n_sub, Ds) rows of the
    ring's diagonal-indexed valid mask."""

    def __init__(self, B: int, valid_seg: torch.Tensor, W: int, col_off: int):
        super().__init__(B, valid_seg, W, nwin_tot=0)
        self.col_off = col_off
        self.nw_s = valid_seg.numel() // W + 1

    def frame(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(wmin, wpos), both (B, nw_s): each window's first minimum and
        its global column, -1 where no valid column reached the window.
        Positions are kept shard-local in the fold (a slot-0 column lies
        below the shard, so its local column is negative) and made global
        here."""
        wmin = self.wmin[:, : self.nw_s]
        wpos = self.wpos[:, : self.nw_s]
        return wmin, torch.where(wmin < BIG, wpos + self.col_off, wpos)


class ClipFold:
    """The per-read window fold of clipped rows: for each read, a running
    (min, first column) per real window, numbered by clip_window_bases,
    folded segment by segment. Equals topk_candidates(reindex=False,
    pack=True) over the one-shot row, bit for bit.

    rows: (n,) i64, the chain's rows this fold reads; qlens (n,) i32 and
    bases (n, T) i64 (clip_window_bases) are theirs; n_win is the most
    real windows of any of them; track_seg and local_seg come from
    prepare_clip_inputs, valid_seg from prepare_chunked_inputs. The
    accumulators are (n, n_win + 1): the last slot takes every column
    that is no real column, and stays BIG."""

    def __init__(self, rows, qlens, bases, n_win: int, track_seg, local_seg,
                 valid_seg, W: int):
        n = rows.shape[0]
        dev = rows.device
        self.rows, self.bases, self.n_win = rows, bases, n_win
        self.qlens = qlens.to(torch.int32)[:, None]
        self.track_seg, self.local_seg, self.valid_seg = track_seg, local_seg, valid_seg
        self.Ds = valid_seg.shape[1]
        self.wmin = torch.full((n, n_win + 1), BIG, dtype=torch.float32, device=dev)
        self.wpos = torch.full((n, n_win + 1), _NO_COL, dtype=torch.int32, device=dev)
        self.cols = torch.arange(self.Ds, dtype=torch.int32, device=dev) - (W - 1)

    def update(self, s: int, scores: torch.Tensor) -> None:
        """Fold segment s's scores: the chain's (B, Ds) block, of which
        this fold reads its rows."""
        valid = self.valid_seg[s][None, :]
        lr = torch.where(valid, scores.index_select(0, self.rows), BIG)
        win = self.bases.index_select(1, self.track_seg[s]) + torch.div(
            self.local_seg[s][None, :], self.qlens, rounding_mode="floor")
        win = torch.where(valid, win, self.n_win)
        old = self.wmin.gather(1, win)
        self.wmin.scatter_reduce_(1, win, lr, "amin")
        new = self.wmin.gather(1, win)
        # a window whose min this segment lowers (strict <: an earlier
        # segment's equal min keeps its first column) takes the first
        # column of this segment that holds the new min
        better = new < old
        self.wpos.scatter_(1, win, torch.where(better, _NO_COL, self.wpos.gather(1, win)))
        first = torch.where(better & (lr == new), self.cols + s * self.Ds, _NO_COL)
        self.wpos.scatter_reduce_(1, win, first, "amin")

    def top5(self, k: int = 5) -> torch.Tensor:
        """The packed (n, 2k) buffer of topk_candidates(pack=True): the
        later window wins ties, an empty slot is (BIG, -1). The windows
        that are never real (pad columns) are left out of the numbering,
        which keeps the real ones' order and so the picks."""
        ts, pick = _select_latest_min(self.wmin, k)
        tp = torch.where(ts >= BIG, -1, self.wpos.gather(1, pick))
        return _pack(ts, tp)


class CornerFold:
    """The --dtw-std corners of a carry chain: for every read, the
    emitted row at one diagonal per track, gathered from the segment
    that holds it into a (B, T) buffer, `corners`.

    diags: (T,) the corner diagonals on the host (Core.std_corner_diags:
    a track's last column + W - 1), each inside the chain's diagonals;
    Ds: the segment length."""

    def __init__(self, B: int, diags: np.ndarray, Ds: int, device):
        diags = np.asarray(diags, dtype=np.int64)
        self.corners = torch.full((B, diags.size), BIG, dtype=torch.float32, device=device)
        seg = diags // Ds
        # segment -> (its tracks, their diagonals inside it)
        self.plan = {}
        for s in np.unique(seg).tolist():
            t = np.nonzero(seg == s)[0]
            self.plan[s] = (torch.from_numpy(t).to(device),
                            torch.from_numpy(diags[t] - s * Ds).to(device))

    def update(self, s: int, scores: torch.Tensor) -> None:
        """Copy the corners that lie in segment s's (B, Ds) scores."""
        if s in self.plan:
            tracks, local = self.plan[s]
            self.corners.index_copy_(1, tracks, scores.index_select(1, local))


def carry_chain(
    queries: torch.Tensor,    # (B, Q) f32
    ypad_seg: torch.Tensor,   # (S, 1, Ds) f32
    rspad_seg: torch.Tensor,  # (S, 1, Ds) f32
    lane: int,                # W - 1
    folds: list,
    start_lanes: torch.Tensor | None = None,
    std: bool = False,        # boundary-anchored DTW (--dtw-std)
    flag_free=None,           # (S,) bools: flag_free_segments; None: none is
) -> dict[str, int]:
    """Stream the reference through the carry kernel, one launch per
    segment from a fresh state, and hand each segment's (B, Ds) scores
    to every fold's update(s, scores). The same start lanes and std go
    to every launch; segment s takes flags=False where flag_free[s].
    Returns the launches of each body (carry_body): {"noflag": n,
    "flag": m}."""
    B, Q = queries.shape
    a1, a2, ywin, rswin = carry_fresh_state(B, Q, queries.device)
    bodies = {"noflag": 0, "flag": 0}
    for s in range(ypad_seg.shape[0]):
        flags = flag_free is None or not flag_free[s]
        warps = carry_warps(B, Q, flags)
        bodies[carry_body(Q, warps, std, flags)] += 1
        scores, a1, a2, ywin, rswin = sdtw_wavefront_carry(
            queries, ypad_seg[s], rspad_seg[s], a1, a2, ywin, rswin,
            lane, start_lanes=start_lanes, std=std, warps=warps, flags=flags,
        )
        for fold in folds:
            fold.update(s, scores)
    return bodies


def sdtw_wavefront_chunked_top5(
    queries: torch.Tensor,    # (B, Q) f32
    ypad_seg: torch.Tensor,   # (S, 1, Ds) f32
    rspad_seg: torch.Tensor,  # (S, 1, Ds) f32
    valid_seg: torch.Tensor,  # (S, Ds) bool
    lane: int,                # W - 1
    W: int,
    nwin_tot: int,            # ceil(R / W)
    k: int = 5,
    start_lanes: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment-streamed sDTW + window fold + top-k on the queries'
    device; returns the packed (B, 2k) buffer of window_top5(pack=True),
    bit-identical to the one-shot kernel followed by window_top5."""
    fold = WindowFold(queries.shape[0], valid_seg, W, nwin_tot)
    carry_chain(queries, ypad_seg, rspad_seg, lane, [fold], start_lanes)
    return fold.top5(k)
