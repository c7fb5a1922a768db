"""Batched subsequence DTW as a column scan: the CUDA kernel's wrapper
and its plain PyTorch version.

Contract (that of sigfish_tpu/ops/sdtw.py::sdtw_scan): B z-scored
queries (B, Q) against one concatenated reference (R,) laid out by
ops/layout.pad_tracks, reset (R,) True at each track's first column. The
carry c is the DP column at j-1 (BIG before the first column and at
every reset). Each column j, with local = |q - y_j|, is computed by the
prefix-min identity:

    s[i]   = local[0] + ... + local[i]
    t[0]   = 0 (std: p0),  t[i] = min(c[i], c[i-1]) - s[i-1]
    new[i] = s[i] + min(t[0], ..., t[i])

p0 is the previous column's row 0, 0 at a reset (boundary-anchored
standard DTW, --dtw-std). Row qlen-1 of each column, picked by a (B, Q)
one-hot, leaves the scan: the last row (B, R) by column. A zero one-hot
row (qlen 0) gives a row of 0, as the JAX one-hot sum does.

min is exact in any order; only the sum's order changes bits. This
module fixes it as the kernel computes it: the Q rows split into 32
contiguous runs of Q/32 rows (one a lane), an inclusive f32 sum down
each run in row order, the run totals chained in lane order (E_0 = 0,
E_{l+1} = E_l + T_l, T_l run l's total), and each row's run sum plus
its run's E.
The JAX package sums in XLA's own order (a reduce-window rewrite on the
CPU), so the two agree within rounding (rtol 2e-5, atol 2e-4, as its
tests hold this engine), while the kernel and scan_plain agree bit for
bit. BIG stays 3.0e38, never inf: t = BIG - s at a reset is finite, so
no NaN appears.

The carry mode takes an initial (B, Q) column (init) and every call
returns the final one, so segments chained through it give bit for bit
the one-shot scan over their concatenation (the ring's hand-off). The
JAX function's ckpt (its scan's column chunk) only pads R here
(ops/layout.pad_tracks pads to it); the kernel does not chunk.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches csrc/scan.cu or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .layout import BIG

# rows per lane the kernel is instantiated for (Q = 32 * rows)
_KERNEL_ROWS = (1, 2, 4, 8, 12, 16)

LANES = 32

# f32 operations a DP cell of the function needs, the count its bound
# is computed from: sub and abs (local), the add (s), min(c, c_up), the
# sub (t), the min (the prefix min), the add (new) and the reset's
# select.
OPS_PER_CELL = 8

# and those the kernel issues a cell besides, for its split into 32 runs:
# the add of the run's E to each run sum (s). The minimum above the run
# (G) enters the prefix min once a run, not a cell. Shuffles and the
# last row's pick are not counted.
RUN_OPS_PER_CELL = 1

# the plain version's precomputed s: at most this many (columns x B x Q)
# elements at once
_S_CHUNK_ELEMS = 1 << 22


def last_rows(onehot: torch.Tensor) -> torch.Tensor:
    """(B,) int32: the index of each one-hot row's 1, -1 where the row is
    all zero (qlen 0)."""
    hot = onehot != 0
    return torch.where(hot.any(dim=1), hot.to(torch.uint8).argmax(dim=1), -1).to(torch.int32)


def onehot_rows(qlens, Q: int, device=None) -> torch.Tensor:
    """The (B, Q) f32 one-hot at qlen - 1 of each row (a zero row for
    qlen 0), as ops/layout.make_query_batch builds it."""
    ql = torch.as_tensor(qlens, dtype=torch.int64).to(device)
    cols = torch.arange(Q, device=device)[None, :]
    return ((cols == (ql - 1)[:, None]) & (ql > 0)[:, None]).to(torch.float32)


def column_sums(queries: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """s for each column value y (C,): (C, B, Q) f32, in the kernel's
    order (a run's sum in row order, the run totals chained in lane
    order, each run's E added)."""
    B, Q = queries.shape
    r = Q // LANES
    # a[k] is row k of every run: (r, C, B, 32)
    x = queries.reshape(B, LANES, r).permute(2, 0, 1).contiguous()
    a = torch.abs(x[:, None] - y[None, :, None, None])
    for k in range(1, r):
        a[k] += a[k - 1]
    e = torch.zeros_like(a[0])
    for lane in range(1, LANES):
        e[..., lane] = e[..., lane - 1] + a[r - 1, ..., lane - 1]
    a[..., 1:] += e[None, ..., 1:]
    return a.permute(1, 2, 3, 0).reshape(-1, B, Q)


def _check(queries, onehot, ref, reset, init):
    if queries.dtype != torch.float32 or onehot.dtype != torch.float32 or ref.dtype != torch.float32:
        raise TypeError("sdtw_scan: queries, onehot and ref must be float32")
    if reset.dtype != torch.bool:
        raise TypeError("sdtw_scan: reset must be bool")
    if queries.dim() != 2 or onehot.shape != queries.shape or ref.dim() != 1 or reset.shape != ref.shape:
        raise ValueError(
            f"sdtw_scan: want queries and onehot (B, Q), ref and reset (R,); got "
            f"{tuple(queries.shape)}, {tuple(onehot.shape)}, {tuple(ref.shape)}, {tuple(reset.shape)}"
        )
    Q = queries.shape[1]
    if Q % LANES:
        raise ValueError(f"sdtw_scan: Q must be a multiple of {LANES}; got Q={Q}")
    devs = {queries.device, onehot.device, ref.device, reset.device}
    if init is not None:
        if init.dtype != torch.float32 or init.shape != queries.shape:
            raise ValueError(f"sdtw_scan: init must be float32 {tuple(queries.shape)}")
        devs.add(init.device)
    if len(devs) != 1:
        raise ValueError(f"sdtw_scan: inputs on several devices {devs}")


def scan_plain(
    queries: torch.Tensor,      # (B, Q) f32, zeros past qlen
    onehot: torch.Tensor,       # (B, Q) f32 one-hot at qlen - 1
    ref: torch.Tensor,          # (R,) f32
    reset: torch.Tensor,        # (R,) bool
    *,
    std: bool = False,
    init: torch.Tensor | None = None,   # (B, Q) carry column; None: BIG
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: (last_row (B, R), final column (B, Q)), in the
    kernel's op order. Runs on whatever device its inputs lie on; the
    column sums come a chunk of columns at a time (they do not depend on
    the carry), then a loop over columns takes the carry. Counted in
    scan_plain.calls."""
    scan_plain.calls += 1
    _check(queries, onehot, ref, reset, init)
    B, Q = queries.shape
    R = ref.shape[0]
    dev = queries.device
    rows = last_rows(onehot).to(torch.int64)
    # each read's row qlen - 1 in the flattened (B, Q) column
    pick = torch.arange(B, device=dev) * Q + rows.clamp(min=0)
    c = torch.full((B, Q), BIG, dtype=torch.float32, device=dev)
    if init is not None:
        c.copy_(init)
    t = torch.zeros((B, Q), dtype=torch.float32, device=dev)
    g = torch.empty((B, Q), dtype=torch.float32, device=dev)
    gi = torch.empty((B, Q), dtype=torch.int64, device=dev)
    out = torch.empty((R, B), dtype=torch.float32, device=dev)
    resets = set(reset.nonzero().flatten().tolist())
    chunk = max(1, _S_CHUNK_ELEMS // max(B * Q, 1))
    for j0 in range(0, R, chunk):
        S = column_sums(queries, ref[j0 : j0 + chunk])
        for jj in range(S.shape[0]):
            j = j0 + jj
            s = S[jj]
            rs = j in resets
            if std:
                if rs:
                    t[:, 0] = 0.0
                else:
                    t[:, 0] = c[:, 0]
            if rs:
                c.fill_(BIG)
            # rows 1..: t = min(c, c_up) - s above (row 0's c_up is BIG)
            torch.minimum(c[:, 1:], c[:, :-1], out=t[:, 1:])
            t[:, 1:] -= s[:, :-1]
            torch.cummin(t, 1, out=(g, gi))
            torch.add(s, g, out=c)
            torch.index_select(c.view(-1), 0, pick, out=out[j])
    out[:, rows < 0] = 0.0
    return out.t().contiguous(), c


scan_plain.calls = 0


def sdtw_scan(
    queries: torch.Tensor,      # (B, Q) f32
    onehot: torch.Tensor,       # (B, Q) f32 one-hot at qlen - 1
    ref: torch.Tensor,          # (R,) f32
    reset: torch.Tensor,        # (R,) bool
    *,
    std: bool = False,
    init: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(last_row (B, R) by column, final column (B, Q)) of the column
    scan over ref from init (BIG when None). CPU tensors run scan_plain;
    CUDA tensors launch csrc/scan.cu (counted in sdtw_scan.launches and,
    with std=True, sdtw_scan.launches_std) on their device's current
    stream, or raise."""
    _check(queries, onehot, ref, reset, init)
    if queries.device.type == "cpu":
        return scan_plain(queries, onehot, ref, reset, std=std, init=init)
    if queries.device.type != "cuda":
        raise ValueError(f"sdtw_scan: unsupported device {queries.device}")
    if queries.shape[1] // LANES not in _KERNEL_ROWS:
        raise ValueError(f"sdtw_scan: the kernel takes Q = 32 * {_KERNEL_ROWS}; "
                         f"got Q={queries.shape[1]}")
    out = launch(_library(), queries, onehot, ref, reset, std, init)
    sdtw_scan.launches += 1
    sdtw_scan.launches_std += bool(std)
    return out


sdtw_scan.launches = 0
sdtw_scan.launches_std = 0


def launch(lib: ctypes.CDLL, queries, onehot, ref, reset, std: bool = False, init=None):
    """One launch of lib's sf_sdtw_scan on the inputs' device and its
    current stream, uncounted: (last_row (B, R), final column (B, Q)).
    sdtw_scan's own launch, and the benches' of an older build."""
    B, Q = queries.shape
    R = ref.shape[0]
    q = queries.contiguous()
    rows = last_rows(onehot)
    y = ref.contiguous()
    rs = reset.contiguous()
    c0 = None if init is None else init.contiguous()
    out = torch.empty((B, R), dtype=torch.float32, device=q.device)
    final = torch.empty((B, Q), dtype=torch.float32, device=q.device)
    # the runtime launches on the calling thread's current device
    with torch.cuda.device(q.device):
        err = lib.sf_sdtw_scan(
            q.data_ptr(), rows.data_ptr(), y.data_ptr(), rs.data_ptr(),
            None if c0 is None else c0.data_ptr(), out.data_ptr(), final.data_ptr(),
            B, Q, R, int(std), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sdtw_scan: CUDA launch failed (cudaError {err})")
    return out, final

_lib: ctypes.CDLL | None = None


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """lib with sf_sdtw_scan's argument types declared (every pointer and
    the stream as c_void_p, so none is cut to 32 bits)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sf_sdtw_scan.argtypes = [p] * 7 + [i, i, i, i, p]
    lib.sf_sdtw_scan.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    """csrc/scan.cu's library, built on first use."""
    global _lib
    if _lib is None:
        from ..kernels.build import load_library

        _lib = _declare(load_library("scan"))
    return _lib
