"""Chunked-reference wavefront sDTW: bounded device memory for
multi-megabase references on one GPU.

The port of sigfish_tpu/ops/chunked_ref.py. The one-shot path holds the
kernel's whole diagonal-indexed score buffer (B, D) before the window
top-5: at B=512 over both strands of a 4.6 Mb genome (9.3M columns) that
is 19 GB, and the top-5 copies it twice more. This path runs the carry
mode of the wavefront kernel (ops/sdtw_wavefront.sdtw_wavefront_carry)
over reference segments, one launch each, and folds each segment's
scores into a running per-window (min, first position) accumulator, so
the device holds

    O(B * Ds)    one segment's scores (Ds ~ 32k diagonals)
  + O(B * G)     the window accumulator, G ~ R / W windows
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
    below 0;
  - within a window the first minimum wins (torch.argmin), and the two
    parts of a split window merge with strict `<`, so the EARLIER part
    wins ties: the reference's first-min-wins window scan
    (sigfish.c:895);
  - the final top-5 over the folded windows is window_top5's
    latest-window-wins selection (candidates_dev._select_latest_min).

Clipped reads (qlen != W) use per-read window grids that do not fold
across segments; the pipeline serves them through the one-shot kernel
in small row groups (runtime/pipeline.Core._chunked_candidates_submit).

The segment loop is on the host: segment offsets are Python ints, and
the launches queue on one stream, each seeing the previous one's state.
The accumulator is updated in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .candidates_dev import BIG, _pack, _select_latest_min
from .layout import PAD
from .sdtw_wavefront import carry_fresh_state, sdtw_wavefront_carry

# chunk once the diagonal-indexed score buffer would pass this many
# columns (the JAX package's threshold; 4*B*D bytes at B=512 is 2 GB)
CHUNK_AUTO_COLS = 1 << 20

# the CUDA kernel's diagonal tile: a segment length that is a multiple of
# it keeps every launch's tiles whole
DIAG_TILE = 32


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
    """Host-side segment prep for sdtw_wavefront_chunked_top5.

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
    B, Q = queries.shape
    S, _, Ds = ypad_seg.shape
    if Ds % W:
        raise ValueError(f"segment length {Ds} is not a multiple of W={W}")
    dev = queries.device
    f32 = torch.float32
    npc = Ds // W                 # whole windows per segment
    p = (-(W - 1)) % W            # left pad to the window grid (1 for W > 1)
    nw_c = (p + Ds + W - 1) // W  # windows a segment touches
    G = S * npc + 2               # window 0 is the guard for columns < 0

    a1, a2, ywin, rswin = carry_fresh_state(B, Q, dev)
    wmin_g = torch.full((B, G), BIG, dtype=f32, device=dev)
    wpos_g = torch.full((B, G), -1, dtype=torch.int32, device=dev)
    widx = torch.arange(nw_c, dtype=torch.int32, device=dev) * W    # (nw_c,)

    for s in range(S):
        scores, a1, a2, ywin, rswin = sdtw_wavefront_carry(
            queries, ypad_seg[s], rspad_seg[s], a1, a2, ywin, rswin,
            lane, start_lanes=start_lanes,
        )
        block = torch.where(valid_seg[s][None, :], scores, BIG)
        if p or nw_c * W != p + Ds:
            block = torch.nn.functional.pad(block, (p, nw_c * W - Ds - p), value=BIG)
        wsc = block.reshape(B, nw_c, W)
        amin = torch.argmin(wsc, dim=2)  # first minimum wins (sigfish.c:895)
        pmin = wsc.gather(2, amin[:, :, None])[:, :, 0]
        col0 = s * Ds - (W - 1) - p      # column of the segment block's first slot
        ppos = (widx + col0)[None, :] + amin.to(torch.int32)
        gw0 = col0 // W + 1              # floor division, as the JAX package's
        assert 0 <= gw0 and gw0 + nw_c <= G, (gw0, nw_c, G)
        cur_m = wmin_g[:, gw0 : gw0 + nw_c]
        cur_p = wpos_g[:, gw0 : gw0 + nw_c]
        # strict <: the EARLIER segment's part of a split window wins ties
        take = pmin < cur_m
        cur_p.copy_(torch.where(take, ppos, cur_p))
        cur_m.copy_(torch.where(take, pmin, cur_m))

    ts, pick = _select_latest_min(wmin_g[:, 1 : 1 + nwin_tot], k)
    tp = wpos_g[:, 1 : 1 + nwin_tot].gather(1, pick)
    tp = torch.where(ts >= BIG, -1, tp)
    return _pack(ts, tp)
