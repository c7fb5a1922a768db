"""The plain reference's candidates and PAF line (sigfish src/sigfish.c).

Each track's last DP row is scanned in windows of qlen columns from the
track's start (the last one cut at the track's end); a window's candidate
is its first minimum (sigfish.c:891-900). Candidates are ranked by score,
the later one (contig by contig, + before -, left to right) winning a tie
(update_aln, sigfish.c:575-626). The line is paf_str's (sigfish.c:628-660)
with C's float arithmetic and rounding.
"""

from __future__ import annotations

import math

import numpy as np


def window_minima(row: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray]:
    """(first minimum, its column) of each window of `width` columns."""
    n = row.size
    nwin = -(-n // width)
    padded = np.full(nwin * width, np.inf, np.float32)
    padded[:n] = row
    w = padded.reshape(nwin, width)
    arg = w.argmin(axis=1)
    return w[np.arange(nwin), arg], arg + np.arange(nwin) * width


def best_two(scores: np.ndarray) -> tuple[int, float]:
    """(index of the best candidate, the runner-up's score): the lowest
    score, the later candidate on a tie; inf without a runner-up."""
    best = scores.size - 1 - int(np.argmin(scores[::-1]))
    rest = np.delete(scores, best)
    return best, float(rest.min()) if rest.size else math.inf


def mapq(d1: float, d2: float) -> int:
    """round(500 (d2 - d1) / d1) in float32, half away from zero, capped at
    60 and stored in a byte; INT_MIN (so 0) where C's cast overflows
    (sigfish.c:979-983)."""
    s1, s2 = np.float32(d1), np.float32(d2)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        x = float(np.float32(500.0) * (s2 - s1) / s1)
    if math.isnan(x) or math.isinf(x) or not -2147483649.0 < x < 2147483648.0:
        q = -(2**31)
    else:
        f = math.floor(abs(x))
        q = int(math.copysign(f + 1 if abs(x) - f >= 0.5 else f, x))
    return min(q, 60) & 0xFF


def _round_i32(x: float) -> int:
    if math.isnan(x) or math.isinf(x):
        return -(2**31)
    r = math.copysign(math.floor(abs(x) + 0.5), x)
    return int(r) if -(2**31) <= r <= 2**31 - 1 else -(2**31)


def _f2(x: float) -> str:
    return ("inf" if x > 0 else "-inf") if math.isinf(x) else f"{x:.2f}"


def paf_line(read_id: str, n_samples: int, start_raw: int, end_raw: int, strand: str,
             rname: str, rlength: int, pos_st: int, pos_end: int, d1: float, d2: float,
             query_size: int) -> str:
    """One PAF line: residue and block length in float32 as the C has them."""
    with np.errstate(divide="ignore", invalid="ignore"):
        block = np.float32(pos_end - pos_st)
        residue = block - np.float32(d1) * block / np.float32(query_size)
    return (f"{read_id}\t{n_samples}\t{start_raw}\t{end_raw}\t{strand}\t{rname}\t{rlength}\t"
            f"{pos_st}\t{pos_end}\t{_round_i32(float(residue))}\t{_round_i32(float(block))}\t"
            f"{mapq(d1, d2)}\ttp:A:P\td1:f:{_f2(d1)}\td2:f:{_f2(d2)}\n")
