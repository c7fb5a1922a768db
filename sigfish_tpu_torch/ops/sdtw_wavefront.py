"""Batched subsequence DTW as an anti-diagonal wavefront: the CUDA
kernel's wrapper and its plain PyTorch version.

Contract (that of sigfish_tpu/ops/sdtw_pallas.py::sdtw_wavefront): B
z-scored queries (B, Q) against one concatenated reference track laid
out by ops/layout.prepare_wavefront_inputs as ypad/rspad (1, D). Lane i
holds query row i; on anti-diagonal d every cell depends only on the
diagonals d-1 and d-2:

    A_d[i] = |x[i] - y[d-i]| + min(A_{d-1}[i-1],
                                   rs ? BIG : min(A_{d-1}[i], A_{d-2}[i-1]))

rs marks a track's first column (the left and diagonal neighbours lie
in the previous track). The free-start lane (0, or a clipped read's
start lane) is |x - y| instead; with std=True it carries the
boundary-anchored first row, local + (rs ? 0 : A_{d-1}). y[d-i] for
d < i is PAD with rs 0, and BIG seeds both carried diagonals. The
result is out[b, d] = A_d[lane], so out[:, lane : lane+R] is the
column-indexed last DP row.

Every cell is `local + min(up, min-or-BIG(left, diag))` in f32 in that
order, and min is exact, so the kernel, the plain version and the JAX
package's kernel agree bit for bit.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches csrc/wavefront.cu or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .layout import BIG, PAD

# rows per thread the kernel is instantiated for (Q = 32 * rows)
_KERNEL_ROWS = (1, 2, 4, 8, 12, 16)


def wavefront_plain(
    queries: torch.Tensor,      # (B, Q) f32
    ypad: torch.Tensor,         # (1, D) f32
    rspad: torch.Tensor,        # (1, D) f32
    lane: int,
    start_lanes: torch.Tensor | None = None,  # (B,) i32
    std: bool = False,
) -> torch.Tensor:
    """The plain version: a loop over diagonals on (B, Q) tensors, in
    the kernel's op order. Runs on whatever device its inputs lie on."""
    B, Q = queries.shape
    D = ypad.shape[1]
    dev = queries.device
    f32 = torch.float32
    lanes = torch.arange(Q, device=dev)
    if start_lanes is None:
        start_lanes = torch.zeros(B, dtype=torch.int32, device=dev)
    fs = lanes[None, :] == start_lanes.to(dev).long()[:, None]   # (B, Q)
    # reference windows as views: ywin_d[i] = y[d-i] (PAD, rs 0 for d < i)
    # is the slice [D-1-d, D-1-d+Q) of the flipped, front-padded track
    yf = torch.cat([torch.full((Q,), PAD, dtype=f32, device=dev), ypad[0]]).flip(0)
    rf = torch.cat([torch.zeros(Q, dtype=f32, device=dev), rspad[0]]).flip(0) > 0.5
    big = torch.tensor(BIG, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    a1 = torch.full((B, Q), BIG, dtype=f32, device=dev)   # A_{d-1}
    b2 = torch.full((B, Q), BIG, dtype=f32, device=dev)   # A_{d-2} shifted by one lane
    out = torch.empty((B, D), dtype=f32, device=dev)
    for d in range(D):
        lo = D - 1 - d
        ywin = yf[lo : lo + Q]
        rs = rf[lo : lo + Q]
        local = torch.abs(queries - ywin)
        up = torch.roll(a1, 1, dims=1)
        ld = torch.where(rs, big, torch.minimum(a1, b2))
        a_new = local + torch.minimum(up, ld)
        if std:
            a_new = torch.where(fs, local + torch.where(rs, zero, a1), a_new)
        else:
            a_new = torch.where(fs, local, a_new)
        out[:, d] = a_new[:, lane]
        a1, b2 = a_new, up
    return out


def _check(queries, ypad, rspad, lane, start_lanes):
    if queries.dtype != torch.float32 or ypad.dtype != torch.float32 or rspad.dtype != torch.float32:
        raise TypeError("sdtw_wavefront: queries, ypad and rspad must be float32")
    if queries.dim() != 2 or ypad.dim() != 2 or ypad.shape[0] != 1 or rspad.shape != ypad.shape:
        raise ValueError(
            f"sdtw_wavefront: want queries (B, Q) and ypad, rspad (1, D); got "
            f"{tuple(queries.shape)}, {tuple(ypad.shape)}, {tuple(rspad.shape)}"
        )
    Q = queries.shape[1]
    if not 0 <= lane < Q:
        raise ValueError(f"sdtw_wavefront: lane {lane} outside [0, {Q})")
    devs = {queries.device, ypad.device, rspad.device}
    if start_lanes is not None:
        devs.add(start_lanes.device)
    if len(devs) != 1:
        raise ValueError(f"sdtw_wavefront: inputs on several devices {devs}")


def sdtw_wavefront(
    queries: torch.Tensor,      # (B, Q) f32
    ypad: torch.Tensor,         # (1, D) f32
    rspad: torch.Tensor,        # (1, D) f32
    lane: int,                  # the uniform qlen-1 row to emit
    start_lanes: torch.Tensor | None = None,  # (B,) i32 free-start lane per read
    std: bool = False,          # boundary-anchored DTW (--dtw-std)
) -> torch.Tensor:
    """Diag-indexed scores (B, D): out[b, d] = cost[lane, d-lane].

    Clipped reads (qlen != lane+1) ride the same emission: shift their
    queries with ops/layout.shift_queries_for_clip and pass its
    start_lanes. CPU tensors run wavefront_plain; CUDA tensors launch the
    kernel (counted in sdtw_wavefront.launches) or raise."""
    _check(queries, ypad, rspad, lane, start_lanes)
    if queries.device.type == "cpu":
        return wavefront_plain(queries, ypad, rspad, lane, start_lanes, std)
    if queries.device.type != "cuda":
        raise ValueError(f"sdtw_wavefront: unsupported device {queries.device}")
    B, Q = queries.shape
    D = ypad.shape[1]
    if Q % 32 or Q // 32 not in _KERNEL_ROWS:
        raise ValueError(
            f"sdtw_wavefront: the kernel takes Q = 32 * {_KERNEL_ROWS}; got Q={Q}"
        )
    lib = _library()
    q = queries.contiguous()
    yp = ypad.contiguous()
    rp = rspad.contiguous()
    sl = None
    if start_lanes is not None:
        sl = start_lanes.to(torch.int32).contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.sf_wavefront(
        q.data_ptr(), yp.data_ptr(), rp.data_ptr(),
        None if sl is None else sl.data_ptr(), out.data_ptr(),
        B, Q, D, lane, int(std), stream,
    )
    if err != 0:
        raise RuntimeError(f"sdtw_wavefront: CUDA launch failed (cudaError {err})")
    sdtw_wavefront.launches += 1
    return out


sdtw_wavefront.launches = 0

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """csrc/wavefront.cu's library, built on first use, with its C
    entry's argument types declared (every pointer and the stream as
    c_void_p, so none is cut to 32 bits)."""
    global _lib
    if _lib is None:
        from ..kernels.build import load_library

        lib = load_library("wavefront")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sf_wavefront.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.sf_wavefront.restype = ctypes.c_int
        _lib = lib
    return _lib
