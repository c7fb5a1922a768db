"""The port's wavefront sDTW (sigfish_tpu_torch/ops/sdtw_wavefront.py)
against the JAX package's Pallas kernel in interpret mode, bit for bit:
the plain PyTorch version runs the same f32 operations in the same
order, and min is exact, so the tolerance is 0.

On the CPU the wrapper runs the plain version. The CUDA kernel is held
to that version on the card (tests/test_torch_gpu.py, and chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sigfish_tpu.ops.sdtw_pallas import sdtw_wavefront as jax_wavefront
from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops import sdtw_wavefront as wf


def _case(seed, W=32, Q=64, td=64):
    """Random multi-track layout with resets and a batch mixing
    full-length and clipped reads, laid out as the pipeline does."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 260, size=int(rng.integers(2, 5)))
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in sizes]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=td, align=W)
    qlens = [W, 11, W - 5, W, 1, W, int(rng.integers(2, W))]
    qlist = [rng.standard_normal(n).astype(np.float32) for n in qlens]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=Q)
    qb_k, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
    ypad, rspad, _ = layout.prepare_wavefront_inputs(ref, reset, Q, td=td)
    return qb_k, fs, ypad, rspad, W - 1, td


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bitwise_vs_pallas_interpret(seed, std):
    qb, fs, ypad, rspad, lane, td = _case(seed)
    want = jax_wavefront(
        jnp.asarray(qb), jnp.asarray(ypad), jnp.asarray(rspad), lane=lane,
        td=td, start_lanes=jnp.asarray(fs), std=std, interpret=True,
    )
    before = wf.sdtw_wavefront.launches
    got = wf.sdtw_wavefront(
        torch.from_numpy(qb), torch.from_numpy(ypad), torch.from_numpy(rspad),
        lane, start_lanes=torch.from_numpy(fs), std=std,
    )
    assert wf.sdtw_wavefront.launches == before  # CPU: no kernel launch
    assert got.shape == (qb.shape[0], ypad.shape[1]) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_plain_without_start_lanes_bitwise():
    """start_lanes=None is every read free-starting at lane 0."""
    qb, _, ypad, rspad, lane, td = _case(7)
    want = jax_wavefront(
        jnp.asarray(qb), jnp.asarray(ypad), jnp.asarray(rspad), lane=lane,
        td=td, interpret=True,
    )
    got = wf.sdtw_wavefront(
        torch.from_numpy(qb), torch.from_numpy(ypad), torch.from_numpy(rspad), lane
    )
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _clipped_case(seed, kind, W=32, Q=64):
    """(queries, start_lanes, ypad, rspad, lane, std) of one of the three
    kinds of read the kernel serves: full-length (every start lane 0),
    clipped (a mix, start lanes up to W-1) and std (clipped, std=True)."""
    qb, fs, ypad, rspad, lane, _ = _case(seed, W=W, Q=Q)
    if kind == "full":
        qb = np.random.default_rng(seed + 100).standard_normal(qb.shape).astype(np.float32)
        fs = np.zeros_like(fs)
    return qb, fs, ypad, rspad, lane, kind == "std"


def _plain_without_wrap(queries, ypad, rspad, lane, start_lanes, std):
    """wavefront_plain with row 0's up and diagonal neighbours BIG
    instead of rolled in from row Q-1: what the kernel computes with more
    than one warp per read."""
    B, Q = queries.shape
    D = ypad.shape[1]
    big = torch.tensor(layout.BIG, dtype=torch.float32)
    zero = torch.tensor(0.0, dtype=torch.float32)
    fs = torch.arange(Q)[None, :] == start_lanes.long()[:, None]
    yf = torch.cat([torch.full((Q,), layout.PAD), ypad[0]]).flip(0)
    rf = torch.cat([torch.zeros(Q), rspad[0]]).flip(0) > 0.5
    a1 = torch.full((B, Q), layout.BIG)
    b2 = torch.full((B, Q), layout.BIG)
    out = torch.empty((B, D), dtype=torch.float32)
    for d in range(D):
        lo = D - 1 - d
        ywin, rs = yf[lo : lo + Q], rf[lo : lo + Q]
        local = torch.abs(queries - ywin)
        up = torch.cat([torch.full((B, 1), layout.BIG), a1[:, :-1]], dim=1)
        ld = torch.where(rs, big, torch.minimum(a1, b2))
        a_new = local + torch.minimum(up, ld)
        if std:
            a_new = torch.where(fs, local + torch.where(rs, zero, a1), a_new)
        else:
            a_new = torch.where(fs, local, a_new)
        out[:, d] = a_new[:, lane]
        a1, b2 = a_new, up
    return out


@pytest.mark.parametrize("kind", ["full", "clipped", "std"])
@pytest.mark.parametrize("seed", [0, 1])
def test_no_leak_below_the_start_lane(seed, kind):
    """The invariant the multi-warp kernel rests on: what row 0's
    neighbours are never reaches the emitted row when every start lane
    is <= lane, so BIG in place of the roll's wrap gives the same scores
    bit for bit."""
    qb, fs, ypad, rspad, lane, std = _clipped_case(seed, kind)
    assert fs.max() <= lane
    args = [torch.from_numpy(a) for a in (qb, ypad, rspad)]
    want = wf.wavefront_plain(args[0], args[1], args[2], lane, torch.from_numpy(fs), std)
    got = _plain_without_wrap(args[0], args[1], args[2], lane, torch.from_numpy(fs), std)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


def _warp_split_model(queries, ypad, rspad, lane, start_lanes, std, warps, ring=4):
    """The multi-warp kernel's data flow in torch, tile by tile: warp k
    holds rows [k*Qw, (k+1)*Qw); on each diagonal the warp below hands up
    its last row's A, reference value and reset flag through a ring of
    32-diagonal tiles, read one diagonal later, the tile's last entry
    carried over to the next tile's first step; warp 0 takes the
    reference and BIG. The warps run as the pipeline does, warp k on tile
    T while warp k-1 is on tile T+1."""
    B, Q = queries.shape
    D = ypad.shape[1]
    Qw = Q // warps
    big = torch.tensor(layout.BIG, dtype=torch.float32)
    zero = torch.tensor(0.0, dtype=torch.float32)
    rows = torch.arange(Q)[None, :] == start_lanes.long()[:, None]
    st = []
    for k in range(warps):
        st.append(dict(
            x=queries[:, k * Qw : (k + 1) * Qw], fs=rows[:, k * Qw : (k + 1) * Qw],
            a1=torch.full((B, Qw), layout.BIG), b2=torch.full((B, Qw), layout.BIG),
            yw=torch.full((Qw,), layout.PAD), rw=torch.zeros(Qw, dtype=torch.bool),
            h=(torch.full((B,), layout.BIG), torch.tensor(layout.PAD), torch.tensor(False)),
        ))
    slots = [[None] * ring for _ in range(warps - 1)]  # boundary k: warp k -> k+1
    out = torch.empty((B, D), dtype=torch.float32)
    n_tiles = (D + 31) // 32
    for time in range(n_tiles + warps - 1):
        for k in range(warps):
            tile = time - k
            if not 0 <= tile < n_tiles:
                continue
            s = st[k]
            d0, slot = 32 * tile, tile % ring
            steps = min(32, D - d0)
            if k < warps - 1:
                slots[k][slot] = (torch.empty((B, 32)), torch.empty(32), torch.zeros(32, dtype=torch.bool))
            for j in range(steps):
                d = d0 + j
                if k == 0:
                    up0, y_in, r_in = big.expand(B), ypad[0, d], rspad[0, d] > 0.5
                elif j == 0:
                    up0, y_in, r_in = s["h"]
                else:
                    ha, hy, hr = slots[k - 1][slot]
                    up0, y_in, r_in = ha[:, j - 1], hy[j - 1], hr[j - 1]
                s["yw"] = torch.cat([y_in.reshape(1), s["yw"][:-1]])
                s["rw"] = torch.cat([r_in.reshape(1), s["rw"][:-1]])
                a1, b2, rs = s["a1"], s["b2"], s["rw"]
                local = torch.abs(s["x"] - s["yw"])
                up = torch.cat([up0.reshape(B, 1), a1[:, :-1]], dim=1)
                ld = torch.where(rs, big, torch.minimum(a1, b2))
                a_new = local + torch.minimum(up, ld)
                if std:
                    a_new = torch.where(s["fs"], local + torch.where(rs, zero, a1), a_new)
                else:
                    a_new = torch.where(s["fs"], local, a_new)
                s["a1"], s["b2"] = a_new, up
                if k < warps - 1:
                    ha, hy, hr = slots[k][slot]
                    ha[:, j], hy[j], hr[j] = a_new[:, -1], s["yw"][-1], s["rw"][-1]
                if lane // Qw == k:
                    out[:, d] = a_new[:, lane - k * Qw]
            if k > 0:
                ha, hy, hr = slots[k - 1][slot]
                s["h"] = (ha[:, 31].clone(), hy[31].clone(), hr[31].clone())
    return out


@pytest.mark.parametrize("kind", ["full", "clipped", "std"])
@pytest.mark.parametrize("warps", [2, 4])
def test_warp_split_pipeline_bitwise(warps, kind):
    """The handoff the kernel's warps use (ring slots, the one-diagonal
    lag, the tile's last entry carried in a register) reproduces the
    plain version's scores bit for bit, the emitted row in an upper warp
    (lane 99 of Q=128)."""
    qb, fs, ypad, rspad, lane, std = _clipped_case(5, kind, W=100, Q=128)
    args = [torch.from_numpy(a) for a in (qb, ypad, rspad)]
    want = wf.wavefront_plain(args[0], args[1], args[2], lane, torch.from_numpy(fs), std)
    got = _warp_split_model(args[0], args[1], args[2], lane, torch.from_numpy(fs), std, warps)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


def test_wavefront_warps_is_a_built_instance():
    """For every Q the kernel takes and B from 1 to 4,096 the rule picks
    an instance that exists: warps in WARPS, Q / (32 * warps) whole."""
    for rows in wf._KERNEL_ROWS:
        Q = 32 * rows
        for B in range(1, 4097):
            w = wf.wavefront_warps(B, Q)
            assert w in wf.WARPS and Q % (32 * w) == 0, (B, Q, w)


def test_wavefront_warps_splits_the_clip_groups():
    """The chunked route's clip groups (16 rows of Q=256) run more than one
    warp per read."""
    assert wf.wavefront_warps(16, 256) > 1


@pytest.mark.parametrize("W", [1, 32, 100, 250, 500])
def test_clip_start_lanes_never_above_lane(W):
    """The kernel's precondition: shift_queries_for_clip gives every read
    a start lane <= lane = W-1 (W - qlen for a clipped read, 0 otherwise)."""
    rng = np.random.default_rng(W)
    Q = 32 * -(-W // 32)
    qlens = rng.integers(0, W + 1, size=64)
    qlens[:3] = (0, 1, W)
    qlist = [rng.standard_normal(int(n)).astype(np.float32) for n in qlens]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=Q)
    _, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
    assert fs.max() <= W - 1 and fs.min() >= 0
    np.testing.assert_array_equal(fs, np.where((qlens > 0) & (qlens < W), W - qlens, 0))


@pytest.mark.parametrize("Q,warps", [(64, 4), (64, 8), (32, 2), (128, 3), (128, 0), (384, 8)])
def test_wrapper_rejects_warps_not_built_for_q(Q, warps):
    qb = torch.zeros((4, Q))
    y = torch.zeros((1, 256))
    with pytest.raises(ValueError, match="warps"):
        wf.sdtw_wavefront(qb, y, y.clone(), 10, warps=warps)


def test_wrapper_accepts_built_warps_on_the_cpu():
    """An allowed warp count runs the plain version on CPU tensors."""
    qb, fs, ypad, rspad, lane, _ = _case(4)
    q, y, r, sl = (torch.from_numpy(a) for a in (qb, ypad, rspad, fs))
    want = wf.sdtw_wavefront(q, y, r, lane, start_lanes=sl)
    for w in (1, 2):
        got = wf.sdtw_wavefront(q, y, r, lane, start_lanes=sl, warps=w)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


def test_wrapper_rejects_bad_inputs():
    qb, fs, ypad, rspad, lane, _ = _case(3)
    q, y, r = (torch.from_numpy(a) for a in (qb, ypad, rspad))
    with pytest.raises(ValueError):
        wf.sdtw_wavefront(q, y, r, lane=qb.shape[1])
    with pytest.raises(TypeError):
        wf.sdtw_wavefront(q.double(), y, r, lane)
    with pytest.raises(ValueError):
        wf.sdtw_wavefront(q, y[0], r[0], lane)
