"""The plain reference's subsequence DTW: every cell
`|x - y| + min(up, left, diag)`, row 0 free (`|x - y|` alone), column 0
summed down, in float32 (sigfish src/cdtw.c:172-227).

Plain PyTorch, one anti-diagonal a step over many rows at once. The order
in which cells are computed does not change a cell's bits: each is one
subtraction, its absolute value, two minimums and one addition of values
that are the same in any order. A long track is cut into chunks, all
swept at once. Each chunk first sweeps `warm` columns before its own,
from a state that no path enters (the free start is exact there). A
chunk's own columns are exact once its warm-up's last column equals, bit
for bit, the previous chunk's last column, since a column decides every
later one. Where that check fails, the chunk is swept again from the
previous chunk's exact last column, in order along the track, so the
result is the exact sequential DP in every case.

Lanes run in reverse (lane r holds query row Q - 1 - r), so a step reads
its reference values as one slice.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float("inf")


def _sweep(yp, x, lane, warm: int, chunk: int, seed=None):
    """Sweep (G, B) rows of chunks: yp (G, 1, T) each chunk's reference
    values, lane r at step t reading yp[..., t + r] (Q - 1 leading pads);
    x (G or 1, B, Q) the reversed queries; lane (G or 1, B, 1) each
    read's last-row lane. With seed (G, B, Q), a column of the exact DP,
    the sweep starts at column warm - 1 and takes that column from seed.
    Returns (last row (G, B, chunk + Q - 1), indexed by step - warm; the
    warm-up's last column (G, B, Q); the chunk's last column)."""
    G, Q = yp.shape[0], x.shape[2]
    B = x.shape[1]
    dev, dt = yp.device, yp.dtype
    d1 = torch.full((G, B, Q), INF, dtype=dt, device=dev)
    d2 = d1.clone()
    rec = torch.full((G, B, chunk + Q - 1), INF, dtype=dt, device=dev)
    cap_warm = torch.full((G, B, Q), INF, dtype=dt, device=dev)
    cap_end = cap_warm.clone()
    idx = lane.expand(G, B, 1)
    t0 = warm - 1 if seed is not None else 0
    end_col = warm + chunk - 1
    for t in range(t0, warm + chunk + Q - 1):
        new = (x - yp[:, :, t : t + Q]).abs()
        new[:, :, :-1] += torch.minimum(torch.minimum(d1[:, :, 1:], d2[:, :, 1:]), d1[:, :, :-1])
        i = t - (warm - 1)
        if 0 <= i < Q:
            if seed is not None:
                new[:, :, Q - 1 - i] = seed[:, :, i]
            cap_warm[:, :, i] = new[:, :, Q - 1 - i]
        if 0 <= t - end_col < Q:
            cap_end[:, :, t - end_col] = new[:, :, Q - 1 - (t - end_col)]
        if t >= warm:
            rec[:, :, t - warm] = new.gather(2, idx).squeeze(2)
        d2, d1 = d1, new
    return rec, cap_warm, cap_end


def last_rows(queries: list[np.ndarray], tracks: list[np.ndarray], device: str = "cuda",
              dtype=torch.float32, chunk: int = 16384, warm: int = 4096) -> tuple[list, int]:
    """Each query's last DP row (its row qlen - 1) over each track, as
    float32 numpy: out[b][t] has one value per column of track t. Also
    returns how many (chunk, read) pairs had to be swept again."""
    B = len(queries)
    Q = max(q.size for q in queries)
    sizes = [int(y.size) for y in tracks]
    C = max(1, min(chunk, max(sizes)))
    L = max(warm, 1) if any(n > C for n in sizes) else 0
    chunks = [(t, c0) for t, n in enumerate(sizes) for c0 in range(0, max(n, 1), C)]
    G = len(chunks)
    T = L + C + 2 * Q - 2
    yp = np.full((G, 1, T), np.inf, np.float32)
    for g, (t, c0) in enumerate(chunks):
        lo = max(c0 - L, 0)
        seg = tracks[t][lo : c0 + C]
        at = Q - 1 + lo - (c0 - L)
        yp[g, 0, at : at + seg.size] = seg
    x = np.zeros((1, B, Q), np.float32)
    qlens = np.array([q.size for q in queries])
    for b, q in enumerate(queries):
        x[0, b, Q - q.size :] = q[::-1]
    dev = torch.device(device)
    yp_d = torch.from_numpy(yp).to(dev, dtype)
    x_d = torch.from_numpy(x).to(dev, dtype)
    lane = torch.from_numpy(Q - qlens).to(dev).view(1, B, 1)
    rec, cap_warm, cap_end = _sweep(yp_d, x_d, lane, L, C)

    # in order along each track: a chunk whose warm-up did not end on the
    # previous chunk's exact last column is swept again from that column
    rows_ok = torch.arange(Q, device=dev).view(1, 1, Q) < torch.from_numpy(qlens).to(dev).view(1, B, 1)
    by_track: dict[int, list[int]] = {}
    for g, (t, _) in enumerate(chunks):
        by_track.setdefault(t, []).append(g)
    redone = 0
    for k in range(1, max(len(v) for v in by_track.values())):
        cur = [v[k] for v in by_track.values() if len(v) > k]
        prev = [v[k - 1] for v in by_track.values() if len(v) > k]
        cur_t, prev_t = torch.tensor(cur, device=dev), torch.tensor(prev, device=dev)
        bad = ((cap_warm[cur_t] != cap_end[prev_t]) & rows_ok).any(2)
        if not bool(bad.any()):
            continue
        gi, bi = torch.nonzero(bad, as_tuple=True)
        g_cur, g_prev = cur_t[gi], prev_t[gi]
        r, _, e = _sweep(yp_d[g_cur], x_d[0, bi].unsqueeze(1), lane[0, bi].unsqueeze(1), L, C,
                         seed=cap_end[g_prev, bi].unsqueeze(1))
        rec[g_cur, bi] = r[:, 0]
        cap_end[g_cur, bi] = e[:, 0]
        redone += int(gi.numel())

    # column j of a chunk is at step warm + j + qlen - 1
    cols = torch.arange(C, device=dev).view(1, 1, C) + (lane.new_tensor(qlens).view(1, B, 1) - 1)
    own = rec.gather(2, cols.expand(G, B, C)).float().cpu().numpy()
    out = []
    for b in range(B):
        out.append([np.concatenate([own[g, b] for g in by_track[t]])[: sizes[t]]
                    for t in range(len(tracks))])
    return out, redone


def cost_matrix(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The full (n, m) subsequence DTW cost matrix of one query over
    reference columns, by anti-diagonals (cdtw.c:172-189)."""
    n, m = x.size, y.size
    cost = np.full((n + 1, m + 1), np.inf, np.float32)  # row/column -1 is inf
    for d in range(n + m - 1):
        i = np.arange(max(0, d - m + 1), min(n, d + 1))
        j = d - i
        loc = np.abs(x[i] - y[j])
        best = np.minimum(np.minimum(cost[i, j + 1], cost[i + 1, j]), cost[i, j])
        cost[i + 1, j + 1] = np.where(i == 0, loc, loc + best)
    return cost[1:, 1:]


def backtrack(cost: np.ndarray, starty: int) -> tuple[list[int], list[int]]:
    """The greedy walk back from (n - 1, starty), ties diag, then left,
    then up (cdtw.c:98-167), with the leading row-0 run cut to its last
    cell (cdtw.c:192-227). Returns (rows, columns) from the start."""
    i, j = cost.shape[0] - 1, starty
    px, py = [i], [j]
    while i > 0 or j > 0:
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            up, diag, left = cost[i - 1, j], cost[i - 1, j - 1], cost[i, j - 1]
            mn = min(up, diag, left)
            if diag == mn:
                i, j = i - 1, j - 1
            elif left == mn:
                j -= 1
            else:
                i -= 1
        px.append(i)
        py.append(j)
    px.reverse()
    py.reverse()
    a = 0
    while a + 1 < len(px) and px[a + 1] == 0:
        a += 1
    return px[a:], py[a:]


def path_start(query: np.ndarray, track: np.ndarray, pos_end: int) -> int:
    """The first reference column of the best path ending at pos_end: the
    mapper's window walk (a window of min(max(2 qlen, 64), pos_end + 1)
    columns ending there, doubled while the path reaches its left edge)."""
    span = min(max(2 * query.size, 64), pos_end + 1)
    while True:
        lo = pos_end + 1 - span
        _, py = backtrack(cost_matrix(query, track[lo : pos_end + 1]), span - 1)
        if py[0] == 0 and lo > 0:
            span = min(span * 2, pos_end + 1)
            continue
        return py[0] + lo
