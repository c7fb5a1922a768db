"""Exact (scalar-order) DTW reference implementation + backtracking.

This module reproduces the mlpy-derived DTW kernels of sigfish with the
same operation order and tie-break semantics, vectorized where that does
not change float semantics. It serves two roles:

  1. golden reference for the batched TPU engine (tests);
  2. production backtracking: the TPU kernel emits last-row scores and
     checkpoint columns; the winning candidate's path is recovered here by
     recomputing a bounded window of DP columns and walking the greedy
     backtrack (the reference instead keeps the full n*m matrix per
     contig, src/sigfish.c:873, and n*m int path buffers, src/cdtw.c:120
     -- a deliberate design departure).

ref: sigfish src/cdtw.c
  - subsequence (cdtw.c:172-189): first row = local cost (free start on
    the reference axis), first column cumulative, recurrence
    min3(up, diag, left) + |x-y|.
  - std_dtw (cdtw.c:70-94): both first row and column boundary-anchored.
  - path (cdtw.c:98-167): greedy backtrack from (n-1, starty); tie-break
    on float equality diag > left > up; at i==0 walks j to 0.
  - subsequence_path (cdtw.c:192-227): backtrack then strip the leading
    row-0 run, keeping the last row-0 entry as the alignment start.
"""

from __future__ import annotations

import numpy as np


def subsequence_cost(query: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Full (n, m) subsequence-DTW cost matrix, column-sequential exact.

    ref: subsequence cdtw.c:172-189. float32 throughout.
    """
    x = query.astype(np.float32)
    y = ref.astype(np.float32)
    n, m = x.size, y.size
    cost = np.empty((n, m), dtype=np.float32)
    cost[0, :] = np.abs(x[0] - y)
    # first column cumulative
    np.cumsum(np.abs(x - y[0]), dtype=np.float32, out=cost[:, 0])
    prev = cost[:, 0].copy()
    for j in range(1, m):
        local = np.abs(x - y[j])
        col = np.empty(n, dtype=np.float32)
        col[0] = local[0]
        # sequential in i -- exact order of the C loop
        c_prev = prev
        acc = col[0]
        for i in range(1, n):
            mn = c_prev[i]
            if c_prev[i - 1] < mn:
                mn = c_prev[i - 1]
            if acc < mn:
                mn = acc
            acc = local[i] + mn
            col[i] = acc
        cost[:, j] = col
        prev = col
    return cost


def std_dtw_cost(query: np.ndarray, ref: np.ndarray, squared: bool = False) -> np.ndarray:
    """Standard DTW cost matrix (boundary anchored). ref: cdtw.c:70-94."""
    x = query.astype(np.float32)
    y = ref.astype(np.float32)
    n, m = x.size, y.size

    def dist(a, b):
        d = np.abs(a - b)
        return (d * d).astype(np.float32) if squared else d.astype(np.float32)

    cost = np.empty((n, m), dtype=np.float32)
    cost[0, 0] = dist(x[0], y[0])
    np.cumsum(dist(x, y[0]), dtype=np.float32, out=cost[:, 0])
    np.cumsum(dist(x[0], y), dtype=np.float32, out=cost[0, :])
    for j in range(1, m):
        local = dist(x, y[j])
        acc = cost[0, j]
        cp = cost[:, j - 1]
        for i in range(1, n):
            mn = cp[i]
            if cp[i - 1] < mn:
                mn = cp[i - 1]
            if acc < mn:
                mn = acc
            acc = local[i] + mn
            cost[i, j] = acc
    return cost


def backtrack_path(cost: np.ndarray, startx: int = -1, starty: int = -1) -> tuple[np.ndarray, np.ndarray]:
    """Greedy backtrack. ref: path cdtw.c:98-167.

    Returns (px, py) in forward order, from (0, 0-ish) to (startx, starty).
    """
    n, m = cost.shape
    if startx >= n or starty >= m:
        raise ValueError("start out of range")
    if startx < 0:
        startx = n - 1
    if starty < 0:
        starty = m - 1
    i, j = startx, starty
    px = [i]
    py = [j]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            up = cost[i - 1, j]
            diag = cost[i - 1, j - 1]
            left = cost[i, j - 1]
            mn = up
            if diag < mn:
                mn = diag
            if left < mn:
                mn = left
            if diag == mn:
                i -= 1
                j -= 1
            elif left == mn:
                j -= 1
            else:
                i -= 1
        px.append(i)
        py.append(j)
    return np.asarray(px[::-1], dtype=np.int64), np.asarray(py[::-1], dtype=np.int64)


def subsequence_path(cost: np.ndarray, starty: int) -> tuple[np.ndarray, np.ndarray]:
    """Backtrack then strip the leading row-0 stutter. ref: cdtw.c:192-227."""
    px, py = backtrack_path(cost, -1, starty)
    a_star = 0
    for i in range(1, px.size):
        if px[i] == 0:
            a_star += 1
        else:
            break
    return px[a_star:], py[a_star:]


def path_to_map(px: np.ndarray, py: np.ndarray, length: int) -> np.ndarray:
    """Reference-position -> (first,last) query-event map for ss tags.

    ref: path_to_map src/sigfish.c:530-571. Returns int32 (length, 2)
    with -1 for reference deletions; a query index repeated across
    reference steps marks those positions deleted (the prev_query_idx
    rule).
    """
    m = np.full((length, 2), -1, dtype=np.int32)
    ref_st = py[0]
    prev_q = -1
    for i in range(px.size):
        ref_idx = int(py[i] - ref_st)
        q = int(px[i])
        if m[ref_idx, 0] == -1:
            m[ref_idx, 0] = q
        m[ref_idx, 1] = q
        if prev_q == q:
            m[ref_idx, 0] = m[ref_idx, 1] = -1
        prev_q = q
    return m


def subsequence_cost_seeded(
    query: np.ndarray,
    ref_cols: np.ndarray,
    seed_col: np.ndarray | None,
    std: bool = False,
) -> np.ndarray:
    """DP over a column window, seeded by a checkpointed carry column.

    ``ref_cols`` are reference values for columns [c0+1 .. c0+w] and
    ``seed_col`` is the DP column at c0 (None -> window starts at column 0,
    which is the cumulative first column).
    Column-sequential, i-loop vectorized with the prefix trick (values may
    differ from the scalar order by ~1 ulp; the backtrack stays internally
    consistent because it reads these same values).
    """
    x = query.astype(np.float32)
    n = x.size
    w = ref_cols.size
    out = np.empty((n, w), dtype=np.float32)
    if seed_col is None:
        # first column is cumulative over |x - y0|
        first = np.cumsum(np.abs(x - np.float32(ref_cols[0])), dtype=np.float32)
        out[:, 0] = first
        prev = first
        start = 1
    else:
        prev = seed_col.astype(np.float32)
        start = 0
    for j in range(start, w):
        local = np.abs(x - np.float32(ref_cols[j]))
        s = np.cumsum(local, dtype=np.float32)
        m = np.minimum(prev, np.concatenate(([np.float32(np.inf)], prev[:-1])))
        t = np.empty(n, dtype=np.float32)
        # std DTW anchors row 0 to the previous column's row 0
        t[0] = prev[0] if std else np.float32(0.0)
        t[1:] = m[1:] - s[:-1]
        g = np.minimum.accumulate(t)
        col = s + g
        out[:, j] = col
        prev = col
    return out
