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


def _plain_in_kernel_arithmetic(queries, ypad, rspad, lane, start_lanes, std):
    """wavefront_plain computed as the CUDA kernel computes a cell: the
    reset flag as 0 or BIG and min-or-BIG(left, diag) as max(min(left,
    diag), flag), and the free-start row given by its inputs instead of a
    select, up 0 (with std: up = rs ? 0 : left and diag +inf)."""
    B, Q = queries.shape
    D = ypad.shape[1]
    inf = torch.tensor(float("inf"))
    fs = torch.arange(Q)[None, :] == start_lanes.long()[:, None]
    yf = torch.cat([torch.full((Q,), layout.PAD), ypad[0]]).flip(0)
    rf = torch.where(torch.cat([torch.zeros(Q), rspad[0]]).flip(0) > 0.5, layout.BIG, 0.0)
    a1 = torch.full((B, Q), layout.BIG)
    b2 = torch.full((B, Q), layout.BIG)
    out = torch.empty((B, D), dtype=torch.float32)
    for d in range(D):
        lo = D - 1 - d
        ywin, flag = yf[lo : lo + Q], rf[lo : lo + Q]
        local = torch.abs(queries - ywin)
        up = torch.roll(a1, 1, dims=1)
        up_c = torch.where(fs, torch.where(flag == 0, a1, 0.0) if std else 0.0, up)
        dg_c = torch.where(fs, inf, b2) if std else b2
        ld = torch.maximum(torch.minimum(a1, dg_c), flag)
        a_new = local + torch.minimum(up_c, ld)
        out[:, d] = a_new[:, lane]
        a1, b2 = a_new, up
    return out


@pytest.mark.parametrize("kind", ["full", "clipped", "std"])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_cell_arithmetic_bitwise(seed, kind):
    """The exactness argument of the kernel's cell: with every A in [+0,
    BIG], the max/min form of the reset and the free-start row made by
    its inputs give wavefront_plain's scores bit for bit."""
    qb, fs, ypad, rspad, lane, std = _clipped_case(seed, kind)
    args = [torch.from_numpy(a) for a in (qb, ypad, rspad, fs)]
    want = wf.wavefront_plain(*args[:3], lane, args[3], std)
    got = _plain_in_kernel_arithmetic(*args[:3], lane, args[3], std)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


def _warp_split_model(queries, ypad, rspad, lane, start_lanes, std, warps, ring=4, state=None):
    """The multi-warp kernel's data flow in torch, tile by tile: warp k
    holds rows [k*Qw, (k+1)*Qw); on each diagonal the warp below hands up
    its last row's A, reference value and reset flag through a ring of
    32-diagonal tiles, read one diagonal later, the tile's last entry
    carried over to the next tile's first step; warp 0 takes the
    reference and BIG. The warps run as the pipeline does, warp k on tile
    T while warp k-1 is on tile T+1.

    With `state` (a1, a2, ywin, rswin in sdtw_wavefront_carry's form) it
    is the carry mode: each warp starts from its own rows of the state,
    warp 0's row 0 with BIG as its diagonal neighbour, and warp k's first
    handoff is the warp below's last row on the diagonal before the
    segment; it returns (scores, a1, a2, ywin, rswin), the rolled a2's
    element 0 from the last warp. Without, it starts fresh and returns
    the scores."""
    B, Q = queries.shape
    D = ypad.shape[1]
    Qw = Q // warps
    big = torch.tensor(layout.BIG, dtype=torch.float32)
    zero = torch.tensor(0.0, dtype=torch.float32)
    rows = torch.arange(Q)[None, :] == start_lanes.long()[:, None]
    if state is None:
        a1_in = torch.full((B, Q), layout.BIG)
        a2_in = torch.full((B, Q), layout.BIG)
        yw_in = torch.full((Q,), layout.PAD)
        rw_in = torch.zeros(Q, dtype=torch.bool)
    else:
        a1_in, a2_in = state[0], state[1].clone()
        yw_in, rw_in = state[2][0], state[3][0] > 0.5
        a2_in[:, 0] = layout.BIG  # warp 0's row 0: BIG, not the wrap
    st = []
    for k in range(warps):
        lo, hi = k * Qw, (k + 1) * Qw
        h = ((torch.full((B,), layout.BIG), torch.tensor(layout.PAD), torch.tensor(False))
             if k == 0 or state is None else (a1_in[:, lo - 1], yw_in[lo - 1], rw_in[lo - 1]))
        st.append(dict(
            x=queries[:, lo:hi], fs=rows[:, lo:hi],
            a1=a1_in[:, lo:hi], b2=a2_in[:, lo:hi], yw=yw_in[lo:hi], rw=rw_in[lo:hi], h=h,
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
                s["last"] = a1[:, -1]  # A_{d-1} of the warp's last row
                s["a1"], s["b2"] = a_new, up
                if k < warps - 1:
                    ha, hy, hr = slots[k][slot]
                    ha[:, j], hy[j], hr[j] = a_new[:, -1], s["yw"][-1], s["rw"][-1]
                if lane // Qw == k:
                    out[:, d] = a_new[:, lane - k * Qw]
            if k > 0:
                ha, hy, hr = slots[k - 1][slot]
                s["h"] = (ha[:, 31].clone(), hy[31].clone(), hr[31].clone())
    if state is None:
        return out
    a2 = torch.cat([s["b2"] for s in st], dim=1)
    a2[:, 0] = st[-1]["last"]  # A_{d-2}[Q-1], written by the last warp
    return (out, torch.cat([s["a1"] for s in st], dim=1), a2,
            torch.cat([s["yw"] for s in st])[None, :],
            torch.cat([s["rw"] for s in st])[None, :].to(torch.float32))


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


def _fresh_state(B, Q):
    return (torch.full((B, Q), layout.BIG), torch.full((B, Q), layout.BIG),
            torch.full((1, Q), layout.PAD), torch.zeros((1, Q)))


def _split_carry(q, y, r, lane, sl, std, warps, state):
    """One carry segment as the kernel computes it at `warps` warps per
    read: at 1 the roll's sweep, which is the plain version."""
    if warps == 1:
        return wf.wavefront_plain(q, y, r, lane, sl, std, *state)
    return _warp_split_model(q, y, r, lane, sl, std, warps, state=state)


def _assert_carry_equal(got, want, sl, what):
    """Scores bitwise, and the state bitwise under carry_state_mask."""
    B, Q = got[1].shape
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want[0].numpy()),
                                  err_msg=f"scores, {what}")
    masks = wf.carry_state_mask(sl, B, Q)
    for name, g, w, m in zip(("a1", "a2", "ywin", "rswin"), got[1:], want[1:], masks):
        assert g.shape == w.shape == m.shape, name
        np.testing.assert_array_equal(_bits(g[m].numpy()), _bits(w[m].numpy()),
                                      err_msg=f"{name}, {what}")


# segment ends of the carry chains: a 1-diagonal segment, one of 36 (not a
# multiple of the 32-diagonal tile), one of 64, then the rest
CARRY_CUTS = (1, 37, 101)


@pytest.mark.parametrize("kind", ["full", "clipped", "std"])
@pytest.mark.parametrize("warps", [2, 4, 8])
def test_carry_warp_split_chain_bitwise(warps, kind):
    """The carry mode's warp pipeline (each warp seeded from its rows of
    the incoming state, warp k's first handoff the warp below's last row,
    the rolled a2's element 0 from the last warp), chained over uneven
    segments: scores bitwise equal to the plain carry chain's, and the
    state under carry_state_mask, which is all of it for full-length
    reads. Q=256, the emitted row 199 in an upper warp."""
    qb, fs, ypad, rspad, lane, std = _clipped_case(6, kind, W=200, Q=256)
    q, y, r, sl = (torch.from_numpy(a) for a in (qb, ypad, rspad, fs))
    D = y.shape[1]
    cuts = [0, *CARRY_CUTS, D]
    st_m = st_p = _fresh_state(*q.shape)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        got = _split_carry(q, y[:, lo:hi], r[:, lo:hi], lane, sl, std, warps, st_m)
        want = wf.wavefront_plain(q, y[:, lo:hi], r[:, lo:hi], lane, sl, std, *st_p)
        _assert_carry_equal(got, want, sl, f"warps={warps}, segment [{lo}, {hi})")
        st_m, st_p = got[1:], want[1:]
    if kind == "full":
        assert all(bool(m.all()) for m in wf.carry_state_mask(sl, *q.shape))


@pytest.mark.parametrize("kind", ["full", "clipped", "std"])
def test_carry_chain_mixing_warp_counts(kind):
    """Consecutive launches at different warp counts (8, 1, 2, 4) give the
    plain carry chain's scores and masked state, and the chained scores
    equal one pass over the whole reference."""
    qb, fs, ypad, rspad, lane, std = _clipped_case(9, kind, W=200, Q=256)
    q, y, r, sl = (torch.from_numpy(a) for a in (qb, ypad, rspad, fs))
    D = y.shape[1]
    cuts = [0, *CARRY_CUTS, D]
    st_m = st_p = _fresh_state(*q.shape)
    parts = []
    for (lo, hi), warps in zip(zip(cuts[:-1], cuts[1:]), (8, 1, 2, 4)):
        got = _split_carry(q, y[:, lo:hi], r[:, lo:hi], lane, sl, std, warps, st_m)
        want = wf.wavefront_plain(q, y[:, lo:hi], r[:, lo:hi], lane, sl, std, *st_p)
        _assert_carry_equal(got, want, sl, f"warps={warps}, segment [{lo}, {hi})")
        st_m, st_p = got[1:], want[1:]
        parts.append(got[0])
    one = wf.wavefront_plain(q, y, r, lane, sl, std)
    np.testing.assert_array_equal(_bits(torch.cat(parts, dim=1).numpy()), _bits(one.numpy()))


def test_carry_state_mask():
    """a1 from the start lane up; the rolled a2's element 0 and those
    above the start lane; the windows whole; all of it without start lanes."""
    a1, a2, yw, rw = wf.carry_state_mask(torch.tensor([0, 3, 7], dtype=torch.int32), 3, 8)
    assert a1.tolist() == [[True] * 8, [False] * 3 + [True] * 5, [False] * 7 + [True]]
    assert a2.tolist() == [[True] * 8, [True] + [False] * 3 + [True] * 4, [True] + [False] * 7]
    assert yw.shape == rw.shape == (1, 8) and bool(yw.all()) and bool(rw.all())
    masks = wf.carry_state_mask(None, 2, 32)
    assert [tuple(m.shape) for m in masks] == [(2, 32), (2, 32), (1, 32), (1, 32)]
    assert all(bool(m.all()) for m in masks)


def test_carry_warps_is_a_built_instance():
    """For every Q the kernel takes and B from 1 to 4,096 the carry rule
    picks an instance that exists: warps in WARPS, Q / (32 * warps) whole."""
    for rows in wf._KERNEL_ROWS:
        Q = 32 * rows
        for B in range(1, 4097):
            w = wf.carry_warps(B, Q)
            assert w in wf.WARPS and Q % (32 * w) == 0, (B, Q, w)


@pytest.mark.parametrize("Q,warps", [(64, 4), (64, 8), (32, 2), (128, 3), (128, 0), (384, 8)])
def test_carry_wrapper_rejects_warps_not_built_for_q(Q, warps):
    qb = torch.zeros((4, Q))
    y = torch.zeros((1, 256))
    state = _fresh_state(4, Q)
    with pytest.raises(ValueError, match="warps"):
        wf.sdtw_wavefront_carry(qb, y, y.clone(), *state, 10, warps=warps)


def test_carry_wrapper_accepts_built_warps_on_the_cpu():
    """An allowed warp count runs the plain version on CPU tensors."""
    qb, fs, ypad, rspad, lane, _ = _case(4)
    q, y, r, sl = (torch.from_numpy(a) for a in (qb, ypad, rspad, fs))
    state = _fresh_state(*q.shape)
    want = wf.sdtw_wavefront_carry(q, y, r, *state, lane, start_lanes=sl)
    before = dict(wf.sdtw_wavefront_carry.launches_by_warps)
    for w in (1, 2):
        got = wf.sdtw_wavefront_carry(q, y, r, *state, lane, start_lanes=sl, warps=w)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(x.numpy()))
    assert wf.sdtw_wavefront_carry.launches_by_warps == before  # CPU: no kernel launch


def test_carry_warps_splits_the_main_fold():
    """The chunked route's main fold (512 rows of Q=256) runs the carry
    mode at more than one warp per read."""
    assert wf.carry_warps(512, 256) > 1


def test_wavefront_warps_is_a_built_instance():
    """For every Q the kernel takes and B from 1 to 4,096 the rule picks
    an instance that exists: warps in WARPS, Q / (32 * warps) whole."""
    for rows in wf._KERNEL_ROWS:
        Q = 32 * rows
        for B in range(1, 4097):
            w = wf.wavefront_warps(B, Q)
            assert w in wf.WARPS and Q % (32 * w) == 0, (B, Q, w)


def test_wavefront_warps_splits_the_clip_groups():
    """A one-shot launch of 16 clipped rows of Q=256 runs more than one
    warp per read."""
    assert wf.wavefront_warps(16, 256) > 1


@pytest.mark.parametrize("Q,picks", [
    (256, {16: 4, 256: 4, 257: 2, 512: 2, 1024: 2}),
    (512, {16: 8, 256: 8, 257: 4, 512: 4, 1024: 4}),
    (128, {16: 4, 512: 2}),
    (384, {16: 4, 256: 4, 512: 2}),
])
def test_wavefront_warps_follows_the_tables_of_its_q(Q, picks):
    """The one-shot rule at Q=512 (the direct-RNA run) is read from its
    own table, Q=256's holds below 512, each capped at what Q builds."""
    assert {B: wf.wavefront_warps(B, Q) for B in picks} == picks


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


def _sass_function(name, body):
    """A function as cuobjdump -sass prints it: (opcode text) per line,
    16 bytes apart; "BRA @n" branches back to instruction n."""
    lines = [f"\t\tFunction : {name}"]
    for i, text in enumerate(body):
        if text.startswith("BRA @"):
            text = f"@P0 BRA 0x{16 * int(text[5:]):x}"
        lines.append(f"        /*{16 * i:04x}*/                   {text} ;  /* 0x000fe200 */")
    return "\n".join(lines)


_SHFL = "SHFL.UP PT, R2, R3, 0x1, RZ"
_SASS = "\n".join([
    "\tcode for sm_90a",
    # one-shot, one warp: a one-step loop of 4 shuffles and 4 more
    _sass_function("_ZN12_GLOBAL__N_116wavefront_kernelILi8ELi1ELb0ELb0ELb0EEEvPKfS2_S2_PKiPfNS_5CarryEiii",
                   ["LDC R1, c[0x0][0x28]"] + [_SHFL] * 4 + ["FADD R4, R5, R6"] * 3 + ["BRA @1", "EXIT"]),
    # carry, two warps: a tile loop (24 shuffles, 40 instructions) around
    # a group loop (12 shuffles, 24 instructions), and a tail loop of one
    # step (3 shuffles, 5 instructions)
    _sass_function("_ZN12_GLOBAL__N_116wavefront_kernelILi4ELi2ELb1ELb1ELb1EEEvPKfS2_S2_PKiPfNS_5CarryEiii",
                   ["LDC R1, c[0x0][0x28]"] + [_SHFL] * 12 + ["FMNMX R4, R5, R6, PT"] * 3
                   + [_SHFL] * 12 + ["FMNMX R4, R5, R6, PT"] * 11 + ["BRA @16", "BRA @1"]
                   + [_SHFL] * 3 + ["FADD R4, R5, R6", "BRA @41", "EXIT", "NOP"]),
])


def test_sass_inner_loop_per_diagonal():
    """scripts/bench_carry.py's SASS count: of the carry instances only,
    the shortest loop whose shuffles make whole groups of four steps (3
    shuffles a step split over warps; 4 a step with one warp), its
    instructions over the steps it covers."""
    from sigfish_tpu_torch.scripts import bench_carry

    got = bench_carry.sass_per_diagonal(_SASS)
    assert list(got) == ["rows=4 warps=2 std=1 fs0=1"]
    v = got["rows=4 warps=2 std=1 fs0=1"]
    assert (v["loop_instructions"], v["shuffles"], v["steps_per_pass"]) == (24, 12, 4)
    assert v["per_diagonal"] == 6
    assert v["top_per_diagonal"] == {"SHFL": 3, "FMNMX": 2.75, "BRA": 0.25}
    one_shot = bench_carry.sass_per_diagonal(_SASS, carry=False)
    assert one_shot["rows=8 warps=1 std=0 fs0=0"]["per_diagonal"] == 8
