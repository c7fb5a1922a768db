"""Host-side layout helpers (numpy) for the device path.

These are the port's own copies of helpers that live, in the JAX
package, inside modules that import jax:

  - pad_tracks, make_query_batch       (sigfish_tpu/ops/sdtw.py)
  - PAD, BIG, prepare_wavefront_inputs,
    shift_queries_for_clip             (sigfish_tpu/ops/sdtw_pallas.py)
  - build_column_maps, unpack_top5     (sigfish_tpu/ops/candidates_dev.py)

The layouts are kept exactly (the PAD tail and rspad[R] = 1 included),
so the port's scores compare with the JAX package's index for index.
"""

from __future__ import annotations

import numpy as np

BIG = 3.0e38  # carry seed of both DP diagonals; never reached by a real cost
PAD = 1.0e18  # reference value of pad columns (far from f32 max: no inf)

# D alignment of the wavefront's (1, D) reference buffers. The CUDA
# kernel needs none; the JAX kernel tiles diagonals in 256-wide blocks,
# and keeping its rounding makes the two packages' buffers array-equal.
WF_ALIGN = 256


def pad_tracks(
    tracks: list[np.ndarray], ckpt: int = 512, align: int = 1
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate per-(contig,strand) tracks; pad to a ckpt multiple.

    With align > 1 every track's segment is padded to an align multiple,
    which makes the candidate windows of width `align` (the common query
    size) coincide with a static reshape on device -- the inter-track pad
    columns carry huge values, so pad windows can never beat a real
    candidate and partial last windows are handled for free (the pad
    cells lose every first-min-wins comparison).

    Returns (ref (R,) f32, reset (R,) bool, offsets (T+1,) i64 of each
    track's start inside the concatenated array).
    """
    starts = np.zeros(len(tracks), dtype=np.int64)
    pos = 0
    for i, t in enumerate(tracks):
        starts[i] = pos
        seg = t.size
        if align > 1:
            seg = ((seg + align - 1) // align) * align
        pos += seg
    total = pos
    R = ((total + ckpt - 1) // ckpt) * ckpt if total else ckpt
    ref = np.full(R, PAD, dtype=np.float32)
    reset = np.zeros(R, dtype=bool)
    for i, t in enumerate(tracks):
        ref[starts[i] : starts[i] + t.size] = t
        if t.size:
            reset[starts[i]] = True
        # the pad gap after a track is its own DP "track" so garbage
        # never leaks across the boundary
        if starts[i] + t.size < (starts[i + 1] if i + 1 < len(tracks) else total):
            reset[starts[i] + t.size] = True
    if total < R:
        reset[total] = True
    offsets = np.concatenate([starts, [total]])
    return ref, reset, offsets


def make_query_batch(
    queries: list[np.ndarray], pad_q: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad per-read z-scored query vectors to a common Q.

    Returns (queries (B, Q) f32, qlens (B,) i32, row_onehot (B, Q) f32).
    Padding rows sit *below* row qlen-1 in the DP, so they never influence
    the extracted last row.
    """
    B = len(queries)
    Q = pad_q or max((q.size for q in queries), default=1)
    Q = max(Q, 1)
    qb = np.zeros((B, Q), dtype=np.float32)
    qlens = np.zeros(B, dtype=np.int32)
    onehot = np.zeros((B, Q), dtype=np.float32)
    for b, q in enumerate(queries):
        L = min(q.size, Q)
        qb[b, :L] = q[:L]
        qlens[b] = L
        if L > 0:
            onehot[b, L - 1] = 1.0
    return qb, qlens, onehot


def prepare_wavefront_inputs(
    ref: np.ndarray, reset: np.ndarray, Q: int, td: int = WF_ALIGN
) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad the concatenated track array for the wavefront kernel.

    Returns (ypad (1, D), rspad (1, D), D) with D = ceil((R+Q)/td)*td.
    """
    R = ref.shape[0]
    D = ((R + Q + td - 1) // td) * td
    ypad = np.full((1, D), PAD, dtype=np.float32)
    ypad[0, :R] = ref
    rspad = np.zeros((1, D), dtype=np.float32)
    rspad[0, :R] = reset.astype(np.float32)
    # D >= R+Q and Q >= 1 for every caller, so the PAD tail always
    # exists; isolate it unconditionally
    assert R < D, "need Q >= 1 so the kernel has a PAD tail to flush into"
    rspad[0, R] = 1.0
    return ypad, rspad, D


def shift_queries_for_clip(
    qb: np.ndarray, qlens: np.ndarray, lane: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side prep for clipped reads on the wavefront kernel.

    Returns (qb_shifted, start_lanes): each read whose qlen != lane+1
    is moved to lanes [lane+1-qlen, lane] so its last DP row lands on
    the kernel's uniform emitted lane; start_lanes ((B,) int32) carries
    the free-start lane per read (0 for full-length reads, whose
    values are untouched)."""
    qb2 = qb.copy()
    lanes = np.zeros(qb.shape[0], dtype=np.int32)
    W = lane + 1
    # qlen > lane+1 cannot be served by this emission (its last DP row
    # lies beyond the emitted lane); silently leaving it unshifted would
    # emit a mid-query row -- reject loudly instead
    assert int(np.max(qlens, initial=0)) <= W, \
        f"qlen {int(np.max(qlens))} > emitted lane width {W}"
    for r in range(qb.shape[0]):
        ql = int(qlens[r])
        if 0 < ql < W:
            s = W - ql
            qb2[r, :] = 0.0
            qb2[r, s : s + ql] = qb[r, :ql]
            lanes[r] = s
    return qb2, lanes


def build_column_maps(
    offsets: np.ndarray, R: int, track_sizes: list[int] | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Static per-core arrays for the concatenated track layout.

    Returns (u (R,) i32 local column index within its track,
             valid (R,) bool real columns vs padding).
    offsets: (T+1,) track start offsets; R: padded concat length;
    track_sizes: real (unpadded) track lengths -- defaults to the offset
    deltas (tight layout).
    """
    u = np.arange(R, dtype=np.int32)
    total = int(offsets[-1])
    valid = np.zeros(R, dtype=bool)
    for t in range(len(offsets) - 1):
        lo, hi = int(offsets[t]), int(offsets[t + 1])
        u[lo:hi] -= lo
        size = hi - lo if track_sizes is None else int(track_sizes[t])
        valid[lo : lo + size] = True
    u[total:] = 0
    return u, valid


def unpack_top5(packed: np.ndarray, k: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of window_top5(pack=True): (B, 2k) f32 ->
    (top_scores (B, k) f32, top_pos (B, k) i32). Returns writable copies."""
    # np.array (not ascontiguousarray): a (1, k) slice of a 1-row buffer
    # counts as contiguous, so ascontiguousarray would return a read-
    # only VIEW of the caller's buffer -- the callers write into these
    ts = np.array(packed[:, :k], dtype=np.float32)
    tp = np.array(packed[:, k:], dtype=np.float32).view(np.int32)
    return ts, tp
