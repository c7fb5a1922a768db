"""The pore-model trainer's E-step DPs: the CUDA kernels' wrappers and
their plain PyTorch versions.

Two batched dynamic programs of models/train_model.py, each over a
ragged batch of cases padded to (B, N) rows and (B, M) columns with
per-case lengths n, m, each followed by its path walk:

  gap_sdtw    the gap-penalised subsequence DTW of sigfish_tpu's
              train_model._subsequence_cost_gap (:168) and its greedy
              backtrack _backtrack_gap (:206), as _dtw_pairs (:234) runs
              them: rows are the dwell-expanded k-mer levels, columns the
              read's events, end = the first argmin of the last row.
              csrc/gap_dtw.cu.
  banded_dtw  the banded, end-anchored DTW with pointers of
              train_model._banded_anchored_dtw (:419): rows are events,
              columns levels, the band jlo..jhi of each row, start and
              end free within end_slack, the end the first minimum of the
              candidates in list order (last row, then last column).
              csrc/banded_dtw.cu.

Both return the path in walk order (from the end cell back to the start)
as (B, N + M) int32 px, py padded with -1 and its length per case;
host_paths reverses each into the (px, py) int64 arrays the JAX functions
return. Every cell is one f32 add or compare in numpy's order, so the
kernels and the plain versions agree with the JAX functions bit for bit:

  - both cumulative sums of the gap DP (the first column and each
    column's s) run sequentially in f32, as numpy's float32 cumsum does
    (torch.cumsum does not: it reorders the adds);
  - the gap DP's up-gap ramp iu = (arange(n) * gu) is computed in f64
    and rounded to f32, as numpy promotes an int64 array times a float32;
  - the prefix minimum (np.minimum.accumulate) is exact in any order;
  - out-of-band cells of the banded DP read BIGF = 3e37, and
    3e37 + 0.5 stays 3e37 in f32.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel (counted in gap_sdtw.launches, banded_dtw.launches)
or raises. The plain versions run on whatever device their inputs lie
on, so the card can hold its kernels to them on the same inputs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

BIGF = 3e37  # the banded DP's out-of-band cost
EMPTY = -1   # end and path entries of an empty case, and past a path's end


def _check(fn: str, x, y, n, m):
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"{fn}: rows and columns must be float32")
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(f"{fn}: want rows (B, N) and columns (B, M); got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    B = x.shape[0]
    for name, t in (("n", n), ("m", m)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{fn}: {name} must be int32 ({B},)")
    if len({x.device, y.device, n.device, m.device}) != 1:
        raise ValueError(f"{fn}: inputs on several devices")
    if B:
        n_lo, n_hi, m_lo, m_hi = torch.stack([n.min(), n.max(), m.min(), m.max()]).tolist()
        if n_lo < 0 or n_hi > x.shape[1] or m_lo < 0 or m_hi > y.shape[1]:
            raise ValueError(f"{fn}: lengths outside [0, {x.shape[1]}] x [0, {y.shape[1]}]")


def pack(rows: list[np.ndarray], device) -> tuple[torch.Tensor, torch.Tensor]:
    """A ragged list of 1-D arrays as (B, max length) f32 zero-padded and
    (B,) int32 lengths on device."""
    L = max((r.size for r in rows), default=0)
    out = np.zeros((len(rows), max(L, 1)), np.float32)
    for b, r in enumerate(rows):
        out[b, : r.size] = r
    lens = np.array([r.size for r in rows], np.int32)
    return torch.from_numpy(out).to(device), torch.from_numpy(lens).to(device)


def host_paths(px: torch.Tensor, py: torch.Tensor, plen: torch.Tensor) -> list[tuple]:
    """Each case's walk-order path reversed into forward (px, py) int64
    arrays, as the JAX functions return them."""
    px, py, plen = px.cpu().numpy(), py.cpu().numpy(), plen.cpu().numpy()
    return [(px[b, : plen[b]][::-1].astype(np.int64), py[b, : plen[b]][::-1].astype(np.int64))
            for b in range(plen.size)]


def _walk(step, i, j, active, L):
    """Run a batched path walk: step(i, j, go) -> (i, j) moves the rows in
    go; a row stops when i reaches 0. Returns px, py (B, L) int32 padded
    with EMPTY and plen (B,) int32."""
    B = i.shape[0]
    dev = i.device
    px = torch.full((B, L), EMPTY, dtype=torch.int32, device=dev)
    py = torch.full((B, L), EMPTY, dtype=torch.int32, device=dev)
    plen = active.to(torch.int32)
    px[:, 0] = torch.where(active, i, EMPTY).to(torch.int32)
    py[:, 0] = torch.where(active, j, EMPTY).to(torch.int32)
    k = 1
    while True:
        go = active & (i > 0)
        if not bool(go.any()):
            break
        i, j = step(i, j, go)
        px[:, k] = torch.where(go, i, EMPTY).to(torch.int32)
        py[:, k] = torch.where(go, j, EMPTY).to(torch.int32)
        plen += go.to(torch.int32)
        active = go
        k += 1
    return px, py, plen


def gap_sdtw_plain(x, y, n, m, gap_up: float, gap_left: float):
    """The plain version of gap_sdtw: the JAX column loop on (B, N)
    tensors, the cumulative sums as sequential f32 adds over rows, and a
    batched walk. Returns (end (B,) int32, end_cost (B,) f32, px, py,
    plen)."""
    B, N = x.shape
    M = y.shape[1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    gu = torch.tensor(gap_up, **f32)
    gl = torch.tensor(gap_left, **f32)
    # padded rows and columns hold garbage that no real cell reads: a
    # cell reads rows at or above its own and the column before
    local = (x[:, :, None] - y[:, None, :]).abs()                 # (B, N, M)
    s_rows, c0_rows = [local[:, 0, :]], [local[:, 0, 0] + gu]
    for i in range(1, N):
        s_rows.append(s_rows[-1] + local[:, i, :])
        c0_rows.append(c0_rows[-1] + (local[:, i, 0] + gu))
    S = torch.stack(s_rows, 1)                                    # (B, N, M)
    iu = (torch.arange(N, dtype=torch.float64, device=dev) * gu.double()).float()
    cost = torch.empty((B, N, M), **f32)
    prev = torch.stack(c0_rows, 1) - gu
    cost[:, :, 0] = prev
    t = torch.zeros((B, N), **f32)
    for j in range(1, M):
        s = S[:, :, j]
        t[:, 1:] = (torch.minimum(prev[:, 1:] + gl, prev[:, :-1]) - s[:, :-1]) - iu[1:]
        col = (s + iu) + torch.cummin(t, dim=1).values
        col[:, 0] = local[:, 0, j]
        cost[:, :, j] = col
        prev = col

    ar = torch.arange(B, device=dev)
    valid = (n > 0) & (m > 0)
    n64, m64 = n.long(), m.long()
    last = cost[ar, (n64 - 1).clamp(min=0), :]
    last = torch.where(torch.arange(M, device=dev)[None, :] < m64[:, None], last, torch.inf)
    end = torch.where(valid, last.argmin(dim=1), EMPTY)
    end_cost = torch.where(valid, last[ar, end.clamp(min=0)], 0.0)

    def step(i, j, go):
        jz = j == 0
        i1, j1 = (i - 1).clamp(min=0), (j - 1).clamp(min=0)
        up = cost[ar, i1, j] + gu
        diag = cost[ar, i1, j1]
        left = cost[ar, i, j1] + gl
        mn = torch.minimum(up, torch.minimum(diag, left))
        dg = ~jz & (diag == mn)
        lf = ~jz & ~dg & (left == mn)
        return torch.where(go & ~lf, i - 1, i), torch.where(go & (dg | lf), j - 1, j)

    px, py, plen = _walk(step, (n64 - 1).clamp(min=0), end.clamp(min=0), valid, N + M)
    return end.to(torch.int32), end_cost, px, py, plen


def gap_sdtw(x, y, n, m, gap_up: float, gap_left: float):
    """Gap-penalised subsequence DTW of each case's rows x[b, :n[b]]
    against its columns y[b, :m[b]] with f32(gap_up) on up moves and
    f32(gap_left) on left moves, and its greedy path from the first
    argmin of the last row. Returns (end (B,) int32, end_cost (B,) f32
    = cost[n-1, end], px, py (B, N + M) int32 in walk order, plen (B,)
    int32); an empty case has end -1, end_cost 0 and no path. CPU
    tensors run gap_sdtw_plain; CUDA tensors launch csrc/gap_dtw.cu
    (counted in gap_sdtw.launches) or raise."""
    _check("gap_sdtw", x, y, n, m)
    if x.device.type == "cpu":
        return gap_sdtw_plain(x, y, n, m, gap_up, gap_left)
    if x.device.type != "cuda":
        raise ValueError(f"gap_sdtw: unsupported device {x.device}")
    B, N = x.shape
    M = y.shape[1]
    lib = _library("gap_dtw")
    x, y = x.contiguous(), y.contiguous()
    dev = x.device
    cost = torch.empty(B * N * M, dtype=torch.float32, device=dev)
    end = torch.empty(B, dtype=torch.int32, device=dev)
    end_cost = torch.empty(B, dtype=torch.float32, device=dev)
    px = torch.full((B, N + M), EMPTY, dtype=torch.int32, device=dev)
    py = torch.full((B, N + M), EMPTY, dtype=torch.int32, device=dev)
    plen = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sf_gap_dtw(x.data_ptr(), y.data_ptr(), n.data_ptr(), m.data_ptr(), B, N, M,
                             gap_up, gap_left, cost.data_ptr(), stream)
        if err == 0:
            err = lib.sf_gap_path(cost.data_ptr(), n.data_ptr(), m.data_ptr(), B, N, M, gap_up,
                                  gap_left, end.data_ptr(), end_cost.data_ptr(), px.data_ptr(),
                                  py.data_ptr(), plen.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gap_sdtw: CUDA launch failed (cudaError {err})")
    gap_sdtw.launches += 1
    return end, end_cost, px, py, plen


gap_sdtw.launches = 0


def banded_dtw_plain(ev, lvl, n, m, band, end_slack: int, gap_up: float = 0.5,
                     gap_left: float = 0.25):
    """The plain version of banded_dtw: the JAX row loop's cells computed
    by anti-diagonal on (B, cells) tensors (every cell reads only the
    two anti-diagonals before its own), the end candidates and a batched
    pointer walk. Returns (end_i, end_j (B,) int32, px, py, plen)."""
    B, N = ev.shape
    M = lvl.shape[1]
    dev = ev.device
    f32 = dict(dtype=torch.float32, device=dev)
    bigf = torch.tensor(BIGF, **f32)
    zero = torch.zeros((), **f32)
    gu = torch.tensor(gap_up, **f32)
    gl = torch.tensor(gap_left, **f32)
    n64, m64 = n.long(), m.long()
    bw = torch.clamp(band.long(), min=end_slack + 8)
    local = (ev[:, :, None] - lvl[:, None, :]).abs()
    cost = torch.full((B, N, M), BIGF, **f32)
    ptr = torch.zeros((B, N, M), dtype=torch.int8, device=dev)
    cols = torch.arange(M, device=dev)
    row0 = (cols[None, :] < torch.minimum(torch.minimum(m64, bw + 1),
                                          torch.full_like(m64, end_slack))[:, None]) & (n64 > 0)[:, None]
    cost[:, 0, :] = torch.where(row0, local[:, 0, :], bigf)
    rows = torch.arange(N, device=dev)
    c = rows[None, :] * m64[:, None] // n64.clamp(min=1)[:, None]
    jlo = (c - bw[:, None]).clamp(min=0)
    jhi = torch.minimum(c + bw[:, None] + 1, m64[:, None])
    live = rows[None, :] < n64[:, None]
    for a in range(1, N + M - 1):
        I = torch.arange(max(1, a - M + 1), min(N - 1, a) + 1, device=dev)
        if I.numel() == 0:
            continue
        J = a - I
        lo = jlo[:, I]
        inb = live[:, I] & (J[None, :] >= lo) & (J[None, :] < jhi[:, I])
        if not bool(inb.any()):
            continue
        J1 = (J - 1).clamp(min=0)
        d = torch.where(J[None, :] > 0, cost[:, I - 1, J1],
                        torch.where(I[None, :] > end_slack, bigf, zero))
        u = cost[:, I - 1, J] + gu
        le = torch.where(J[None, :] > lo, cost[:, I, J1], bigf) + gl
        up = u < d
        best = torch.where(up, u, d)
        lf = le < best
        best = torch.where(lf, le, best)
        p = torch.where(lf, 2, torch.where(up, 1, 0)).to(torch.int8)
        cost[:, I, J] = torch.where(inb, local[:, I, J] + best, cost[:, I, J])
        ptr[:, I, J] = torch.where(inb, p, ptr[:, I, J])

    ar = torch.arange(B, device=dev)
    valid = (n64 > 0) & (m64 > 0)
    k = torch.arange(end_slack, device=dev)[None, :]
    cj = m64[:, None] - end_slack + k                 # last row, columns in order
    ci = n64[:, None] - end_slack + k                 # last column, rows in order
    vj = cost[ar[:, None], (n64 - 1).clamp(min=0)[:, None], cj.clamp(min=0)]
    vi = cost[ar[:, None], ci.clamp(min=0), (m64 - 1).clamp(min=0)[:, None]]
    cand = torch.cat([torch.where(cj >= 0, vj, torch.inf), torch.where(ci >= 0, vi, torch.inf)], 1)
    w = cand.argmin(dim=1)
    on_row = w < end_slack
    ei = torch.where(on_row, n64 - 1, ci[ar, (w - end_slack).clamp(min=0)])
    ej = torch.where(on_row, cj[ar, w.clamp(max=end_slack - 1)], m64 - 1)
    ei = torch.where(valid, ei, EMPTY)
    ej = torch.where(valid, ej, EMPTY)

    def step(i, j, go):
        p = ptr[ar, i, j]
        di = go & (p != 2)
        dj = go & (((p == 0) & (j > 0)) | (p == 2))
        return torch.where(di, i - 1, i), torch.where(dj, j - 1, j)

    px, py, plen = _walk(step, ei.clamp(min=0), ej.clamp(min=0), valid, N + M)
    return ei.to(torch.int32), ej.to(torch.int32), px, py, plen


def banded_dtw(ev, lvl, n, m, band, end_slack: int, gap_up: float = 0.5, gap_left: float = 0.25):
    """Banded, end-anchored DTW of each case's events ev[b, :n[b]] (rows)
    against its levels lvl[b, :m[b]] (columns): row i's band is
    (i*m)//n -/+ max(band[b], end_slack + 8), the path starts in row 0
    within the first end_slack columns (or in column 0 of the first
    end_slack rows) and ends at the first minimum of the last row's last
    end_slack columns, then the last column's last end_slack rows.
    Returns (end_i, end_j (B,) int32, px, py (B, N + M) int32 in walk
    order, plen (B,) int32); an empty case has end -1 and no path. CPU
    tensors run banded_dtw_plain; CUDA tensors launch csrc/banded_dtw.cu
    (counted in banded_dtw.launches) or raise."""
    _check("banded_dtw", ev, lvl, n, m)
    B = ev.shape[0]
    if band.dtype != torch.int32 or tuple(band.shape) != (B,) or band.device != ev.device:
        raise ValueError(f"banded_dtw: band must be int32 ({B},) on {ev.device}")
    if end_slack < 1:
        raise ValueError(f"banded_dtw: end_slack {end_slack} < 1 leaves no end candidate")
    if ev.device.type == "cpu":
        return banded_dtw_plain(ev, lvl, n, m, band, end_slack, gap_up, gap_left)
    if ev.device.type != "cuda":
        raise ValueError(f"banded_dtw: unsupported device {ev.device}")
    N, M = ev.shape[1], lvl.shape[1]
    lib = _library("banded_dtw")
    ev, lvl = ev.contiguous(), lvl.contiguous()
    dev = ev.device
    cost = torch.full((B * N * M,), BIGF, dtype=torch.float32, device=dev)
    ptr = torch.zeros(B * N * M, dtype=torch.int8, device=dev)
    ei = torch.empty(B, dtype=torch.int32, device=dev)
    ej = torch.empty(B, dtype=torch.int32, device=dev)
    px = torch.full((B, N + M), EMPTY, dtype=torch.int32, device=dev)
    py = torch.full((B, N + M), EMPTY, dtype=torch.int32, device=dev)
    plen = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sf_banded_dtw(ev.data_ptr(), lvl.data_ptr(), n.data_ptr(), m.data_ptr(),
                                band.data_ptr(), B, N, M, end_slack, gap_up, gap_left,
                                cost.data_ptr(), ptr.data_ptr(), stream)
        if err == 0:
            err = lib.sf_banded_path(cost.data_ptr(), ptr.data_ptr(), n.data_ptr(), m.data_ptr(),
                                     B, N, M, end_slack, ei.data_ptr(), ej.data_ptr(),
                                     px.data_ptr(), py.data_ptr(), plen.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"banded_dtw: CUDA launch failed (cudaError {err})")
    banded_dtw.launches += 1
    return ei, ej, px, py, plen


banded_dtw.launches = 0


def gap_pairs(rows: list[np.ndarray], cols: list[np.ndarray], gap_up: float, gap_left: float,
              device) -> tuple[np.ndarray, np.ndarray, list[tuple]]:
    """gap_sdtw over a list of cases on device: (end (B,) i64, end_cost
    (B,) f32, [(px, py)] forward int64 paths)."""
    x, n = pack(rows, device)
    y, m = pack(cols, device)
    end, end_cost, px, py, plen = gap_sdtw(x, y, n, m, gap_up, gap_left)
    return (end.cpu().numpy().astype(np.int64), end_cost.cpu().numpy(),
            host_paths(px, py, plen))


def banded_pairs(evs: list[np.ndarray], lvls: list[np.ndarray], bands: list[int],
                 end_slack: int, device) -> list[tuple]:
    """banded_dtw over a list of cases on device: [(px, py)] forward
    int64 paths (px events, py levels)."""
    ev, n = pack(evs, device)
    lvl, m = pack(lvls, device)
    band = torch.tensor(bands, dtype=torch.int32).to(device)
    return host_paths(*banded_dtw(ev, lvl, n, m, band, end_slack)[2:])


_libs: dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    """csrc/<name>.cu's library, built on first use."""
    if name not in _libs:
        from ..kernels.build import load_library

        lib = load_library(name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "gap_dtw":
            lib.sf_gap_dtw.argtypes = [p, p, p, p, i, i, i, f, f, p, p]
            lib.sf_gap_path.argtypes = [p, p, p, i, i, i, f, f, p, p, p, p, p, p]
            lib.sf_gap_dtw.restype = lib.sf_gap_path.restype = ctypes.c_int
        else:
            lib.sf_banded_dtw.argtypes = [p, p, p, p, p, i, i, i, i, f, f, p, p, p]
            lib.sf_banded_path.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p]
            lib.sf_banded_dtw.restype = lib.sf_banded_path.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
