"""Candidate extraction and ranking from sDTW last-row scores.

ref: sigfish src/sigfish.c
  - window scan (sigfish.c:891-900,936-948): the last DP row of each
    (contig, strand) track is scanned in non-overlapping windows of width
    qlen; the per-window argmin (strict <, first-min-wins) is a candidate.
    The final window may be truncated at the track end.
  - update_aln (sigfish.c:575-626): an ascending 5-slot list keyed by
    score; on ties the newer candidate ranks better. Only the best
    alignment is printed and only the runner-up score (d2) is consumed
    (SECONDARY_CAP exists to compute d2, ref sigfish.h:41), so ranking
    reduces to a top-2 by (score asc, insertion-order desc).
  - '-' strand coordinates flipped pos = rlen - pos (sigfish.c:971-972),
    ref_st_offset added for RNA truncated tracks (sigfish.c:974-975).
  - mapq = round(500*(d2-d1)/d1) clamped to 60 (sigfish.c:979-983).

Candidate insertion order is contig-major, '+' strand windows
left-to-right then '-' strand windows (dtw_single loop structure,
sigfish.c:870-964) -- preserved here because it decides ties.
"""

from __future__ import annotations

import math

import numpy as np


def window_argmin(scores: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-window (min, argmin) with first-min-wins over a 1-D track.

    ref: sigfish.c:891-900. Returns (mins, argmins) where argmins are
    positions within the track.
    """
    n = scores.size
    if n == 0 or width <= 0:
        return np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.int64)
    nwin = (n + width - 1) // width
    pad = nwin * width - n
    if pad:
        padded = np.concatenate([scores, np.full(pad, np.inf, dtype=scores.dtype)])
    else:
        padded = scores
    w = padded.reshape(nwin, width)
    arg = w.argmin(axis=1)  # numpy argmin = first occurrence = strict < scan
    mins = w[np.arange(nwin), arg]
    return mins.astype(np.float32), arg + np.arange(nwin, dtype=np.int64) * width


def rank_candidates(
    cand_scores: np.ndarray, cand_pos: np.ndarray
) -> tuple[int, float, float]:
    """Top-2 with update_aln tie semantics (later candidate wins ties).

    Returns (best_index_into_candidates, d1, d2). Candidates must be in
    insertion order. ref: update_aln sigfish.c:575-583.
    """
    if cand_scores.size == 0:
        return -1, float("inf"), float("inf")
    # best: smallest score; ties -> latest insertion
    rev = cand_scores[::-1]
    best_rev = int(np.argmin(rev))  # first occurrence in reversed = latest
    best = cand_scores.size - 1 - best_rev
    d1 = float(cand_scores[best])
    if cand_scores.size == 1:
        return best, d1, float("inf")
    rest = np.delete(cand_scores, best)
    rrev = rest[::-1]
    d2 = float(rrev[np.argmin(rrev)])
    return best, d1, d2


def compute_mapq(d1: float, d2: float) -> int:
    """ref: sigfish.c:979-983 plus the uint8_t store at sigfish.h:153.

    The reference computes ``(int)round(500*(score2-score)/score)`` where the
    scores are C floats, clamps only the >60 side, and stores into a uint8_t.
    Three behaviors matter for byte parity:
      - the expression is evaluated in float32 (both operands are floats);
      - round() is half AWAY from zero (not Python banker's rounding);
      - (int) of inf/nan/overflow yields INT_MIN on x86-64 (cvttsd2si), and
        the uint8_t narrowing store keeps the low byte -> mapq prints 0 for
        single-candidate references (d2=inf) or d1=0.
    """
    s1 = np.float32(d1)
    s2 = np.float32(d2)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        x = float(np.float32(500.0) * (s2 - s1) / s1)
    if math.isnan(x) or math.isinf(x) or not (-2147483649.0 < x < 2147483648.0):
        mapq = -(2**31)
    else:
        f = math.floor(abs(x))
        r = f + 1 if abs(x) - f >= 0.5 else f
        mapq = int(math.copysign(r, x))
        if not (-(2**31) <= mapq < 2**31):
            mapq = -(2**31)
    if mapq > 60:
        mapq = 60
    return mapq & 0xFF
