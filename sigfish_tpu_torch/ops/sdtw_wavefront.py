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
package's kernel agree bit for bit. (The carry mode computes
min-or-BIG as a max with a 0-or-BIG flag, and the free-start row from
its inputs; csrc/wavefront.cu's header shows these give the same bits.)

The kernel splits each read's Q rows over `warps` warps of a block
(1, 2, 4 or 8; wavefront_warps picks the one-shot count and carry_warps
the carry mode's from B and Q). With more than one, row 0's up and
diagonal neighbours are BIG instead of the roll's wrap from row Q-1.
Those values reach only rows below the read's free-start lane, so the
scores equal the plain version's bit for bit provided every start lane
is <= lane, as ops/layout.shift_queries_for_clip gives. The carry
mode's outgoing state differs from the roll's only in the entries
carry_state_mask leaves out, which no row at or above the start lane
ever reads.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches csrc/wavefront.cu or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .layout import BIG, PAD

# rows per thread the kernel is instantiated for (Q = 32 * rows)
_KERNEL_ROWS = (1, 2, 4, 8, 12, 16)

# warps per read the kernel is instantiated for, in both modes (rows per
# lane Q / (32 * warps) must be whole)
WARPS = (1, 2, 4, 8)

# warps per read of the one-shot kernel by batch size, as (largest B,
# warps) steps: the fastest instance in chip_smoke.py phase 5's tables of
# ms per launch on an H100 (PERF.md), at Q=256 over D=60,672 (B up to
# 1,024) and at Q=512 over the direct-RNA reference's D=160,768 (B up to
# 512). Only those two widths were measured: every Q below 512 takes the
# Q=256 table, every Q from 512 the Q=512 one. Each table's last step
# holds beyond its largest B (the pipeline launches at most DEVICE_CHUNK
# = 512 rows).
_ONESHOT_WARPS = {
    256: ((256, 4), (None, 2)),
    512: ((256, 8), (None, 4)),
}

# the largest batch the carry mode runs at 2 warps per read (1 above):
# where 2 is the fastest instance in chip_smoke.py phase 5's table of ms
# per segment launch at Q=256 over Ds=32,000 on an H100 (PERF.md)
_CARRY_TWO_WARPS_MAX_B = 512

# f32 operations the recurrence needs per DP cell, the count every bound
# of the sweep is computed from: sub and abs (local), min(left, diag),
# the reset select, min with up, add, and the free-start select. Moving
# values between lanes and picking the emitted lane are not counted.
OPS_PER_CELL = 7


def carry_fresh_state(B: int, Q: int, device) -> tuple[torch.Tensor, ...]:
    """The carry state before a reference's first diagonal, in
    sdtw_wavefront_carry's form: a1 and a2 BIG (B, Q), ywin PAD and rswin
    0 (1, Q)."""
    f32 = torch.float32
    return (
        torch.full((B, Q), BIG, dtype=f32, device=device),
        torch.full((B, Q), BIG, dtype=f32, device=device),
        torch.full((1, Q), PAD, dtype=f32, device=device),
        torch.zeros((1, Q), dtype=f32, device=device),
    )


def wavefront_plain(
    queries: torch.Tensor,      # (B, Q) f32
    ypad: torch.Tensor,         # (1, D) f32
    rspad: torch.Tensor,        # (1, D) f32
    lane: int,
    start_lanes: torch.Tensor | None = None,  # (B,) i32
    std: bool = False,
    a1: torch.Tensor | None = None,     # (B, Q) incoming A_{d-1}
    a2: torch.Tensor | None = None,     # (B, Q) incoming roll(A_{d-2})
    ywin: torch.Tensor | None = None,   # (1, Q) incoming reference window
    rswin: torch.Tensor | None = None,  # (1, Q) incoming reset window
):
    """The plain version: a loop over diagonals on (B, Q) tensors, in
    the kernel's op order. Runs on whatever device its inputs lie on.

    Without a carry it starts fresh (BIG diagonals, a PAD window) and
    returns the scores (B, D). With the carry (a1, a2, ywin, rswin) --
    all four or none, in sdtw_wavefront_carry's form -- it starts from
    that state and returns (scores, a1, a2, ywin, rswin), the state after
    the segment's last diagonal. Counted in wavefront_plain.calls."""
    wavefront_plain.calls += 1
    B, Q = queries.shape
    D = ypad.shape[1]
    dev = queries.device
    f32 = torch.float32
    carry = a1 is not None
    if carry != (a2 is not None) or carry != (ywin is not None) or carry != (rswin is not None):
        raise ValueError("wavefront_plain: pass all four of a1, a2, ywin, rswin or none")
    if not carry:
        a1, a2, ywin, rswin = carry_fresh_state(B, Q, dev)
    lanes = torch.arange(Q, device=dev)
    if start_lanes is None:
        start_lanes = torch.zeros(B, dtype=torch.int32, device=dev)
    fs = lanes[None, :] == start_lanes.to(dev).long()[:, None]   # (B, Q)
    # reference windows as views: ywin_d[i] = y[d-i] is the slice
    # [D-1-d, D-1-d+Q) of the flipped track behind its incoming window
    # (for d < i, lane i reads ywin[i-d-1]: PAD and rs 0 when fresh)
    yf = torch.cat([ywin[0].flip(0), ypad[0]]).flip(0)
    rf = torch.cat([rswin[0].flip(0), rspad[0]]).flip(0) > 0.5
    big = torch.tensor(BIG, dtype=f32, device=dev)
    zero = torch.tensor(0.0, dtype=f32, device=dev)
    b2 = a2                                               # A_{d-2} shifted by one lane
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
    if not carry:
        return out
    return out, a1, b2, yf[None, :Q].clone(), rf[None, :Q].to(f32)


wavefront_plain.calls = 0


def wavefront_warps(B: int, Q: int) -> int:
    """Warps per read for a one-shot launch of B reads of Q rows, from
    _ONESHOT_WARPS: many where B leaves most of the card's 528 schedulers
    idle and each read's chain of steps is the whole time (fewer rows per
    lane make every step shorter), fewer once B fills them. At Q=256: 4
    up to B=256, 2 beyond; at Q=512: 8 up to B=256, 4 beyond. The
    largest count built for Q at or below the table's."""
    steps = _ONESHOT_WARPS[512 if Q >= 512 else 256]
    want = next(w for b_max, w in steps if b_max is None or B <= b_max)
    return _built_warps(want, Q)


def carry_warps(B: int, Q: int) -> int:
    """Warps per read for a carry launch of B reads of Q rows: 2 up to
    B=512 (the chunked route's main fold), 1 beyond, from the carry
    mode's own table. Its cells are cheaper than the one-shot mode's (no
    compare per cell without start lanes, reset flags as 0 or BIG), so
    fewer warps per read pay off sooner. The largest count built for Q
    at or below the table's."""
    return _built_warps(2 if B <= _CARRY_TWO_WARPS_MAX_B else 1, Q)


def _built_warps(want: int, Q: int) -> int:
    """The largest warp count built for Q at or below `want`."""
    return max(w for w in WARPS if w <= want and Q % (32 * w) == 0)


def _check_warps(fn: str, warps: int | None, Q: int) -> None:
    if warps is not None and (warps not in WARPS or Q % (32 * warps)):
        raise ValueError(
            f"{fn}: warps must be one of {WARPS} with Q a multiple of "
            f"32 * warps; got warps={warps}, Q={Q}"
        )


def carry_state_mask(start_lanes: torch.Tensor | None, B: int, Q: int, device=None):
    """The entries of the carry mode's outgoing state (a1, a2, ywin,
    rswin) that the kernel guarantees bitwise equal to wavefront_plain's
    for every warp count, as four bool masks of the state's shapes.

    With start lane s: a1's rows >= s, and the rolled a2's element 0
    (A_{d-2}[Q-1]) and elements s+1 .. Q-1 (rows >= s of A_{d-2}); all
    of ywin and rswin. With every start lane 0 (or None) that is all of
    it. The rest are rows below s, computed from BIG in place of the
    roll's wrap when a read is split over warps; row s depends only on
    itself, so no row >= s ever reads them, and chained segments keep
    their scores whatever warp counts they mix."""
    rows = torch.arange(Q, device=device)[None, :]
    s = (torch.zeros(B, dtype=torch.long, device=device) if start_lanes is None
         else start_lanes.to(device=device, dtype=torch.long))[:, None]
    a1 = rows >= s
    a2 = (rows == 0) | (rows > s)
    full = torch.ones((1, Q), dtype=torch.bool, device=device)
    return a1, a2, full, full.clone()


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
    warps: int | None = None,   # warps per read; None: wavefront_warps(B, Q)
) -> torch.Tensor:
    """Diag-indexed scores (B, D): out[b, d] = cost[lane, d-lane].

    Clipped reads (qlen != lane+1) ride the same emission: shift their
    queries with ops/layout.shift_queries_for_clip and pass its
    start_lanes. Precondition: every start lane is <= lane. With more than
    one warp per read the rows below a start lane differ from the plain
    version's, so a start lane above lane would change the emitted row.
    CPU tensors run wavefront_plain; CUDA tensors launch the kernel
    (counted in sdtw_wavefront.launches, per warp count in
    sdtw_wavefront.launches_by_warps and, with std=True, in
    sdtw_wavefront.launches_std) or raise."""
    _check(queries, ypad, rspad, lane, start_lanes)
    B, Q = queries.shape
    _check_warps("sdtw_wavefront", warps, Q)
    if queries.device.type == "cpu":
        return wavefront_plain(queries, ypad, rspad, lane, start_lanes, std)
    if queries.device.type != "cuda":
        raise ValueError(f"sdtw_wavefront: unsupported device {queries.device}")
    D = ypad.shape[1]
    if Q % 32 or Q // 32 not in _KERNEL_ROWS:
        raise ValueError(
            f"sdtw_wavefront: the kernel takes Q = 32 * {_KERNEL_ROWS}; got Q={Q}"
        )
    if warps is None:
        warps = wavefront_warps(B, Q)
    lib = _library()
    q = queries.contiguous()
    yp = ypad.contiguous()
    rp = rspad.contiguous()
    sl = None
    if start_lanes is not None:
        sl = start_lanes.to(torch.int32).contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=q.device)
    # the runtime launches on the calling thread's current device
    with torch.cuda.device(q.device):
        err = lib.sf_wavefront(
            q.data_ptr(), yp.data_ptr(), rp.data_ptr(),
            None if sl is None else sl.data_ptr(), out.data_ptr(),
            B, Q, D, lane, int(std), warps, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sdtw_wavefront: CUDA launch failed (cudaError {err})")
    sdtw_wavefront.launches += 1
    sdtw_wavefront.launches_by_warps[warps] += 1
    sdtw_wavefront.launches_std += bool(std)
    return out


sdtw_wavefront.launches = 0
sdtw_wavefront.launches_by_warps = dict.fromkeys(WARPS, 0)
sdtw_wavefront.launches_std = 0


def sdtw_wavefront_carry(
    queries: torch.Tensor,      # (B, Q) f32
    ypad: torch.Tensor,         # (1, D) f32: one reference segment
    rspad: torch.Tensor,        # (1, D) f32
    a1: torch.Tensor,           # (B, Q) incoming A_{d-1} (BIG when fresh)
    a2: torch.Tensor,           # (B, Q) incoming roll(A_{d-2}) (BIG when fresh)
    ywin: torch.Tensor,         # (1, Q) incoming window, ywin[i] = y[d-1-i] (PAD when fresh)
    rswin: torch.Tensor,        # (1, Q) incoming reset window, f32 0/1 (0 when fresh)
    lane: int,
    start_lanes: torch.Tensor | None = None,
    std: bool = False,
    warps: int | None = None,   # warps per read; None: carry_warps(B, Q)
):
    """sdtw_wavefront over one reference segment with explicit
    cross-segment state; returns (scores (B, D), a1, a2, ywin, rswin).

    Segments run back to back through this function, each fed the
    previous call's state, give bit for bit the scores of one
    sdtw_wavefront over their concatenation. The state is the JAX
    package's (sdtw_pallas.sdtw_wavefront_carry): a2 is the diagonal
    d-2 rolled by one lane, so the two packages' states compare value
    for value. start_lanes must be the same on every segment of a chain,
    and every start lane <= lane.

    What the kernel guarantees, for every warp count: the scores are
    bitwise equal to the plain version's; with every start lane 0 so is
    all of the outgoing state; with start lanes s, the state under
    carry_state_mask (a1 rows >= s, the rolled a2's elements 0 and
    s+1..Q-1, all of ywin and rswin). The rest, rows below s, no row >= s
    ever reads, so a chain may mix warp counts from launch to launch.
    CPU tensors run wavefront_plain; CUDA tensors launch the kernel's
    carry mode, counted in sdtw_wavefront_carry.launches, per warp count
    in sdtw_wavefront_carry.launches_by_warps, when start lanes are
    given (the instance without FS0) in
    sdtw_wavefront_carry.launches_start_lanes and, with std=True, in
    sdtw_wavefront_carry.launches_std, or raise."""
    _check(queries, ypad, rspad, lane, start_lanes)
    B, Q = queries.shape
    _check_warps("sdtw_wavefront_carry", warps, Q)
    for name, t, shape in (("a1", a1, (B, Q)), ("a2", a2, (B, Q)),
                           ("ywin", ywin, (1, Q)), ("rswin", rswin, (1, Q))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(
                f"sdtw_wavefront_carry: {name} must be float32 {shape}; got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != queries.device:
            raise ValueError(f"sdtw_wavefront_carry: {name} on {t.device}, queries on {queries.device}")
    if queries.device.type == "cpu":
        return wavefront_plain(queries, ypad, rspad, lane, start_lanes, std, a1, a2, ywin, rswin)
    if queries.device.type != "cuda":
        raise ValueError(f"sdtw_wavefront_carry: unsupported device {queries.device}")
    D = ypad.shape[1]
    if Q % 32 or Q // 32 not in _KERNEL_ROWS:
        raise ValueError(
            f"sdtw_wavefront_carry: the kernel takes Q = 32 * {_KERNEL_ROWS}; got Q={Q}"
        )
    if D < 1:
        raise ValueError("sdtw_wavefront_carry: empty segment")
    if warps is None:
        warps = carry_warps(B, Q)
    lib = _library()
    q = queries.contiguous()
    state_in = [t.contiguous() for t in (a1, a2, ywin, rswin)]
    sl = None if start_lanes is None else start_lanes.to(torch.int32).contiguous()
    out = torch.empty((B, D), dtype=torch.float32, device=q.device)
    # fresh outputs: every warp reads the incoming window, so it cannot
    # be overwritten in place
    state_out = [torch.empty_like(t) for t in state_in]
    yp, rp = ypad.contiguous(), rspad.contiguous()
    with torch.cuda.device(q.device):
        err = lib.sf_wavefront_carry(
            q.data_ptr(), yp.data_ptr(), rp.data_ptr(),
            None if sl is None else sl.data_ptr(),
            *(t.data_ptr() for t in state_in), out.data_ptr(),
            *(t.data_ptr() for t in state_out),
            B, Q, D, lane, int(std), warps, torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"sdtw_wavefront_carry: CUDA launch failed (cudaError {err})")
    sdtw_wavefront_carry.launches += 1
    sdtw_wavefront_carry.launches_by_warps[warps] += 1
    sdtw_wavefront_carry.launches_start_lanes += sl is not None
    sdtw_wavefront_carry.launches_std += bool(std)
    return (out, *state_out)


sdtw_wavefront_carry.launches = 0
sdtw_wavefront_carry.launches_by_warps = dict.fromkeys(WARPS, 0)
sdtw_wavefront_carry.launches_start_lanes = 0
sdtw_wavefront_carry.launches_std = 0

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
        lib.sf_wavefront.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        lib.sf_wavefront.restype = ctypes.c_int
        lib.sf_wavefront_carry.argtypes = [p] * 13 + [i, i, i, i, i, i, p]
        lib.sf_wavefront_carry.restype = ctypes.c_int
        _lib = lib
    return _lib
