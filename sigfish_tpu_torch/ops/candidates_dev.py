"""Candidate extraction on the scores' device: window argmin + top-k,
after the wavefront kernel, so only (B, 2k) packed values reach the host.

Torch ports of sigfish_tpu/ops/candidates_dev.py's device_window_top5
and device_topk_candidates, bit-equal to them. The reference's candidate
semantics (sigfish.c:891-900 window scan, update_aln:575-626):

  - windows of width qlen_b per (contig, strand) track, first minimum
    wins within a window (torch.argmin returns the first minimal index)
  - top-k across windows in track order, the later window wins ties
    (a reversed argmin)
  - packed output: (B, 2k) f32, scores then positions bitcast from i32
    (ops/layout.unpack_top5 inverts it)
"""

from __future__ import annotations

import numpy as np
import torch

BIG = float(np.float32(3.0e38))  # exactly representable: no rounding on use


def _pack(ts: torch.Tensor, tp: torch.Tensor) -> torch.Tensor:
    return torch.cat([ts, tp.to(torch.int32).view(torch.float32)], dim=1)


def _select_latest_min(wm: torch.Tensor, k: int):
    """k rounds of (min, latest index among ties) over the last axis;
    each pick is masked to BIG before the next round. Returns the
    picked values and indices, both (B, k)."""
    wm = wm.clone()
    n = wm.shape[1]
    vals, picks = [], []
    for _ in range(k):
        ar = torch.argmin(wm.flip(1), dim=1)
        pick = (n - 1) - ar
        vals.append(wm.gather(1, pick[:, None])[:, 0])
        picks.append(pick)
        wm.scatter_(1, pick[:, None], BIG)
    return torch.stack(vals, dim=1), torch.stack(picks, dim=1)


def window_top5(
    scores: torch.Tensor,   # (B, D) diag scores (reindex=True) or (B, >=R) last row
    valid: torch.Tensor,    # (R,) bool, False on pad columns
    R: int,
    W: int,
    k: int = 5,
    reindex: bool = True,
    pack: bool = False,
):
    """Uniform-window-width candidate extraction (full-length reads).

    Requires the track layout of pad_tracks(..., align=W): every track
    starts at a multiple of W, so the per-track windows of width W
    coincide with a (B, R/W, W) reshape. Rows whose qlen != W get
    garbage here; topk_candidates serves them.

    Returns (top_scores (B, k) best-first, top_pos (B, k) i32 global
    columns; empty slots score >= BIG, pos -1), or with pack=True one
    (B, 2k) f32 tensor."""
    B = scores.shape[0]
    lr = scores[:, W - 1 : W - 1 + R] if reindex else scores[:, :R]
    lr = torch.where(valid[None, :], lr, BIG)
    nwin = (R + W - 1) // W
    if nwin * W != R:  # tail-pad to a whole window (pad never wins)
        lr = torch.nn.functional.pad(lr, (0, nwin * W - R), value=BIG)
    wsc = lr.reshape(B, nwin, W)
    warg = torch.argmin(wsc, dim=2)  # first minimum wins within a window
    wmin = wsc.gather(2, warg[:, :, None])[:, :, 0]
    wpos = warg.to(torch.int32) + (
        torch.arange(nwin, dtype=torch.int32, device=scores.device) * W
    )[None, :]
    ts, pick = _select_latest_min(wmin, k)
    tp = wpos.gather(1, pick)
    tp = torch.where(ts >= BIG, -1, tp)
    if pack:
        return _pack(ts, tp)
    return ts, tp


def topk_candidates(
    scores: torch.Tensor,   # (B, D) diag scores (reindex=True) or (B, R) last row
    qlens: torch.Tensor,    # (B,) i32
    u: torch.Tensor,        # (R,) i32 local column index per concat column
    valid: torch.Tensor,    # (R,) bool
    R: int,
    k: int = 5,
    reindex: bool = True,
    pack: bool = False,
):
    """Per-read window widths: the device path for CLIPPED reads (qlen
    != W, sigfish.c:457-461 short-read semantics).

    A column starts a window where its track-local index is a multiple
    of the read's qlen (or where it is padding, so no window crosses a
    track). Window minima come from one segmented amin reduction and
    each window's first minimal position from a second: min is exact,
    so the result is bit-equal to the JAX package's scan formulation.
    Returns what window_top5 returns."""
    B = scores.shape[0]
    dev = scores.device
    cols = torch.arange(R, device=dev)
    if reindex:
        # diag -> column: row b's column c sits at diagonal c + qlen_b - 1
        sh = (torch.clamp(qlens.to(torch.int64), min=1) - 1)[:, None]
        lr = scores.gather(1, cols[None, :] + sh)
    else:
        lr = scores[:, :R]
    lr = torch.where(valid[None, :], lr, BIG)

    qw = torch.clamp(qlens.to(torch.int64), min=1)[:, None]
    ws = ((u.to(torch.int64)[None, :] % qw) == 0) | ~valid[None, :]
    seg = torch.cumsum(ws.to(torch.int64), dim=1) - 1          # (B, R) window id
    # a window is real when its last column is a valid column
    we = torch.cat([ws[:, 1:], torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1)
    we = we & valid[None, :]

    big = torch.full((B, R), BIG, dtype=torch.float32, device=dev)
    segmin = big.scatter_reduce(1, seg, lr, "amin", include_self=True)
    real = torch.zeros((B, R), dtype=torch.int64, device=dev).scatter_reduce(
        1, seg, we.to(torch.int64), "amax", include_self=True
    ) > 0
    hit = lr == segmin.gather(1, seg)
    colb = cols[None, :].expand(B, R)
    first = torch.full((B, R), R, dtype=torch.int64, device=dev).scatter_reduce(
        1, seg, torch.where(hit, colb, R), "amin", include_self=True
    )
    wm = torch.where(real, segmin, BIG)
    ts, pick = _select_latest_min(wm, k)
    tp = torch.where(ts >= BIG, -1, first.gather(1, pick)).to(torch.int32)
    if pack:
        return _pack(ts, tp)
    return ts, tp


def select_topk_cands(sc: torch.Tensor, pos: torch.Tensor, k: int = 5):
    """k selection rounds over an unordered candidate list: sc (B, C)
    scores (BIG for an empty slot) and pos (B, C) i32 global first-min
    columns (-1 for an empty slot). Each round takes the least score,
    and among its ties the largest position: update_aln's insertion
    order (sigfish.c:577-583, the later window wins ties), since windows
    are disjoint column ranges and so position order is window order.
    -2 sorts below an empty slot's -1, so an empty slot wins only when
    every slot is empty. Returns (scores (B, k) best-first, pos (B, k)),
    as the JAX package's select_topk_cands."""
    sc = sc.clone()
    rows = torch.arange(sc.shape[0], device=sc.device)
    top_s, top_p = [], []
    for _ in range(k):
        m = sc.min(dim=1, keepdim=True).values
        pick = torch.argmax(torch.where(sc <= m, pos, -2), dim=1)  # the first of equal maxima
        s = sc[rows, pick]
        top_s.append(s)
        top_p.append(torch.where(s >= BIG, -1, pos[rows, pick]))
        sc[rows, pick] = BIG
    return torch.stack(top_s, dim=1), torch.stack(top_p, dim=1)


def merge_gathered_topk(gathered: torch.Tensor, n_tp: int, k: int = 5) -> torch.Tensor:
    """Merge n_tp shards' packed top-k lists, (B, n_tp * 2k) shard-major,
    into the global packed (B, 2k). Exact: a window the whole-row
    selection picks in round j has at most j-1 windows ranked above it,
    so it is in its own shard's top-k, and select_topk_cands over the
    union repeats the whole-row order, ties included (the shards hold
    disjoint W-aligned column ranges)."""
    B = gathered.shape[0]
    blocks = gathered.reshape(B, n_tp, 2 * k)
    sc = blocks[:, :, :k].reshape(B, n_tp * k)
    pos = blocks[:, :, k:].contiguous().view(torch.int32).reshape(B, n_tp * k)
    return _pack(*select_topk_cands(sc, pos, k))
