"""The port's --mesh engines (sigfish_tpu_torch/parallel/shard.py) against
the JAX package's, bit for bit: shard_tracks, select_topk_cands and
merge_gathered_topk, the tracks engine's packed (B, 4k) against
sharded_engine_topk and the ring engine's packed (B, 2k) against
ring_topk_wavefront, both JAX engines on their Pallas wavefront in
interpret mode over tests/conftest.py's 8 CPU devices. The port runs
its grids over "cpu" entries, with the kernels' plain versions.

The layouts are integer-valued, so exact score ties are common: the
merges must reproduce update_aln's insertion order (sigfish.c:577-583)
and first-min-wins windows (sigfish.c:895). The tolerance is 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sigfish_tpu.ops import candidates_dev as jcd
from sigfish_tpu.parallel import shard as jshard
from sigfish_tpu_torch.ops import candidates_dev as tcd
from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops.sdtw_wavefront import wavefront_plain
from sigfish_tpu_torch.parallel import shard as tshard

W, Q, TD = 16, 32, 32
LANE = W - 1


def _jmesh(n_dp, n_tp):
    return Mesh(np.asarray(jax.devices()[: n_dp * n_tp]).reshape(n_dp, n_tp), ("dp", "tp"))


def _tmesh(n_dp, n_tp):
    mesh = tshard.make_mesh(n_dp, n_tp, ["cpu"] * (n_dp * n_tp))
    return mesh, tshard.shard_streams(mesh)


def _queries(rng, qlens):
    """Integer-valued queries of the given lengths, through
    make_query_batch and shift_queries_for_clip as the pipeline does."""
    qs = [rng.integers(0, 3, n).astype(np.float32) for n in qlens]
    qb, ql, _ = layout.make_query_batch(qs, pad_q=Q)
    qb_k, fs = layout.shift_queries_for_clip(qb, ql, LANE)
    return qb, qb_k, ql, fs


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("align", [1, W])
def test_shard_tracks_matches_jax(seed, align):
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(0, 400, size=int(rng.integers(1, 9)))]
    if seed == 2:
        sizes[0] = 0  # an empty track keeps its slot and gets no reset
    tracks = [rng.standard_normal(s).astype(np.float32) for s in sizes]
    for n_tp in (1, 2, 3, 4):
        got = tshard.shard_tracks(tracks, n_tp, ckpt=TD, align=align)
        want = jshard.shard_tracks(tracks, n_tp, ckpt=TD, align=align)
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got[3] == want[3]


def test_make_mesh_grid_and_error():
    mesh = tshard.make_mesh(2, 3, [f"cpu:{i}" for i in range(7)])
    assert [[d.index for d in row] for row in mesh] == [[0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError, match="need 8 devices, have 7"):
        tshard.make_mesh(4, 2, ["cpu"] * 7)
    with pytest.raises(ValueError, match=r"need 2 devices, have \d+"):
        tshard.make_mesh(2, 1, [])


def _random_lists(rng, B, C):
    """Candidate lists with planted score ties and empty slots."""
    sc = rng.integers(0, 4, (B, C)).astype(np.float32)
    pos = np.stack([rng.permutation(10 * C)[:C] for _ in range(B)]).astype(np.int32)
    empty = rng.random((B, C)) < 0.25
    empty[0] = True  # a row of nothing but empty slots
    sc[empty] = np.float32(tcd.BIG)
    pos[empty] = -1
    return sc, pos


@pytest.mark.parametrize("seed", [0, 1])
def test_select_topk_cands_matches_jax(seed):
    sc, pos = _random_lists(np.random.default_rng(seed), 9, 14)
    for k in (1, 5):
        ts, tp = tcd.select_topk_cands(torch.from_numpy(sc), torch.from_numpy(pos), k)
        js, jp = jcd.select_topk_cands(jnp.asarray(sc), jnp.asarray(pos), k)
        assert np.array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))
        assert np.array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("n_tp", [1, 2, 3])
def test_merge_gathered_topk_matches_jax(n_tp):
    rng = np.random.default_rng(10 + n_tp)
    sc, pos = _random_lists(rng, 7, 5 * n_tp)
    g = np.concatenate(
        [np.concatenate([sc[:, 5 * s : 5 * s + 5], pos[:, 5 * s : 5 * s + 5].view(np.float32)], 1)
         for s in range(n_tp)], 1)
    got = tcd.merge_gathered_topk(torch.from_numpy(g), n_tp).numpy()
    want = np.asarray(jcd.merge_gathered_topk(jnp.asarray(g), n_tp))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _tracks_case(seed, n_tp):
    """shard_tracks' layout of a tie-heavy multi-track reference, with
    each shard's wavefront buffers and column maps, as Core lays it out."""
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(20, 200, size=5)]
    tracks = [rng.integers(0, 3, s).astype(np.float32) for s in sizes]
    sref, sreset, soffs, assign = tshard.shard_tracks(tracks, n_tp, ckpt=TD, align=W)
    Rs = sref.shape[1]
    offsets = np.zeros(len(tracks) + 1, np.int64)
    for s, a in enumerate(assign):
        for li, gi in enumerate(a):
            offsets[gi] = s * Rs + soffs[s, li]
    offsets[-1] = n_tp * Rs
    u, valid = layout.build_column_maps(offsets, n_tp * Rs, track_sizes=sizes)
    pads = [layout.prepare_wavefront_inputs(sref[s], sreset[s], Q, td=TD) for s in range(n_tp)]
    ypad = np.concatenate([p[0] for p in pads])
    rspad = np.concatenate([p[1] for p in pads])
    return sref, sreset, ypad, rspad, u.reshape(n_tp, Rs), valid.reshape(n_tp, Rs), Rs, rng


@pytest.mark.parametrize("n_dp,n_tp", [(2, 1), (1, 2), (2, 2), (4, 2)])
def test_tracks_engine_matches_jax(n_dp, n_tp):
    """sharded_topk's packed (B, 4k) equals sharded_engine_topk's, with
    clipped rows and a batch of 7 rows padded to a multiple of DP as the
    pipeline pads it (full-length rows)."""
    sref, sreset, ypad, rspad, u, valid, Rs, rng = _tracks_case(n_dp * 10 + n_tp, n_tp)
    qb, qb_k, ql, _ = _queries(rng, [W, 5, W, W - 3, 1, W, 11])
    padb = (-qb.shape[0]) % n_dp
    qb_k = np.pad(qb_k, ((0, padb), (0, 0)))
    ql = np.pad(ql, (0, padb), constant_values=W)
    onehot = np.zeros_like(qb_k)
    want = np.asarray(jshard.sharded_engine_topk(
        jnp.asarray(qb_k), jnp.asarray(onehot), jnp.asarray(ql), jnp.asarray(sref),
        jnp.asarray(sreset), jnp.asarray(ypad), jnp.asarray(rspad), jnp.asarray(u),
        jnp.asarray(valid), _jmesh(n_dp, n_tp), Rs=Rs, lane=LANE, ckpt=TD, td=TD,
        use_pallas=True, clip_shift=True, interpret=True,
    ))
    mesh, streams = _tmesh(n_dp, n_tp)
    bufs = [[tuple(torch.from_numpy(a[s]) for a in (ypad[:, None], rspad[:, None], u, valid))
             for s in range(n_tp)] for _ in range(n_dp)]
    got = tshard.sharded_topk(qb_k, ql, bufs, mesh, streams, Rs, LANE)
    assert len(got) == n_dp
    got = torch.cat(got).numpy()
    assert got.shape == (qb_k.shape[0], 20)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _ring_case(seed, n_tp, Rs, sizes):
    """A tie-heavy layout cut into n_tp shards of Rs columns, its PAD
    tail and the diagonal-indexed valid mask, as Core lays out a ring."""
    rng = np.random.default_rng(seed)
    tracks = [rng.integers(0, 3, s).astype(np.float32) for s in sizes]
    ref, reset, offs = layout.pad_tracks(tracks, ckpt=TD, align=W)
    R0, R = ref.shape[0], n_tp * Rs
    assert R0 + Q <= R
    ypad = np.full(R, layout.PAD, np.float32)
    ypad[:R0] = ref
    rsl = np.zeros(R, bool)
    rsl[:R0] = reset
    rsl[R0] = True
    _, valid = layout.build_column_maps(offs, R, track_sizes=sizes)
    vd = np.zeros(R, bool)
    vd[LANE:] = valid[: R - LANE]
    return ypad, rsl.astype(np.float32), vd, rng


@pytest.mark.parametrize("n_tp,Rs,n_sub,sizes", [
    (4, 256, 1, (270, 80, 500)),
    (4, 256, 4, (270, 80, 500)),
    (2, 384, 3, (400, 190)),
    (4, W * 2, 1, (50,)),   # Rs == TD == 2W
    (4, W, 1, (20,)),       # the degenerate Rs == W: only boundary windows
])
def test_ring_engine_matches_jax(n_tp, Rs, n_sub, sizes):
    """ring_topk's packed (B, 2k) equals ring_topk_wavefront's, clipped
    rows (start lanes) included, over every step of the schedule."""
    td = TD if (Rs // n_sub) % TD == 0 else W
    ypad, rspad, vd, rng = _ring_case(n_tp * 100 + Rs + n_sub, n_tp, Rs, sizes)
    _, qb_k, _, fs = _queries(rng, [W, 9, W, W, 3, W, W - 1, W])
    n_micro = 4
    want = np.asarray(jshard.ring_topk_wavefront(
        jnp.asarray(qb_k), jnp.asarray(fs), jnp.asarray(ypad.reshape(n_tp, Rs)),
        jnp.asarray(rspad.reshape(n_tp, Rs)), jnp.asarray(vd.reshape(n_tp, Rs)),
        _jmesh(1, n_tp), n_micro=n_micro, lane=LANE, W=W, Rs=Rs, n_sub=n_sub, td=td,
        unroll=4, interpret=True,
    ))
    (devices,), (streams,) = _tmesh(1, n_tp)
    Ds = Rs // n_sub
    bufs = [tuple(torch.from_numpy(np.ascontiguousarray(a[s * Rs : (s + 1) * Rs]).reshape(shape))
                  for a, shape in ((ypad, (n_sub, 1, Ds)), (rspad, (n_sub, 1, Ds)),
                                   (vd, (n_sub, Ds))))
            for s in range(n_tp)]
    calls = wavefront_plain.calls
    got = tshard.ring_topk(qb_k, fs, bufs, devices, streams, n_micro, LANE, W, Rs).numpy()
    assert wavefront_plain.calls - calls == n_micro * n_tp * n_sub  # a carry call a sub-chunk
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("R,n_tp,unit,ref_chunk,want", [
    (9_283_584 + 256, 4, 64_000, 0, (2_368_000, 37)),  # E. coli over 1x4: auto sub-chunks
    (10_000, 4, 512, 0, (2_560, 1)),                   # under the auto threshold
    (10_000, 4, 512, -1, (2_560, 1)),
    (20_000, 4, 512, 2_600, (5_120, 2)),               # 2,560 nearest of 5,120, 2,560, 1,024, 512
    (10_000, 2, 1_024, 1_300, (5_120, 5)),             # divisors 1, 5: 1,024 is nearest
])
def test_ring_shape_rule(R, n_tp, unit, ref_chunk, want):
    """Rs and n_sub by the JAX Core's rule (pipeline.py:301-327)."""
    assert tshard.ring_shape(R, n_tp, unit, ref_chunk) == want
