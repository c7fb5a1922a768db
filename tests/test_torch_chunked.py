"""The port's chunked-reference path against the JAX package's, bit for
bit: the carry mode of the wavefront op (scores and all four state
tensors against sdtw_wavefront_carry in interpret mode), the segment
fold and top-5 (against sdtw_wavefront_chunked_top5), and the pipeline's
chunked route (PAF against Core(engine="pallas", ref_chunk=...)), through
the library and the CLI. The tolerance is 0 throughout: the same f32
operations in the same order, and min is exact.

On the CPU the wrappers run the plain versions; the CUDA carry kernel is
held to them on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sigfish_tpu.ops.candidates_dev import device_topk_candidates, device_window_top5
from sigfish_tpu.ops.chunked_ref import (
    prepare_chunked_inputs as jax_prepare_chunked,
    sdtw_wavefront_chunked_top5 as jax_chunked_top5,
)
from sigfish_tpu.ops.sdtw_pallas import sdtw_wavefront as jax_wavefront
from sigfish_tpu.ops.sdtw_pallas import sdtw_wavefront_carry as jax_carry
from sigfish_tpu_torch.ops import chunked_ref as cr
from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops import sdtw_wavefront as wf
from sigfish_tpu_torch.ops.candidates_dev import BIG, topk_candidates, window_top5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = 32  # the JAX kernel's tile in these tests


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _fresh(B, Q):
    return (
        np.full((B, Q), np.float32(layout.BIG), np.float32),
        np.full((B, Q), np.float32(layout.BIG), np.float32),
        np.full((1, Q), np.float32(layout.PAD), np.float32),
        np.zeros((1, Q), np.float32),
    )


def _case(seed, W=32, Q=64, clipped=True):
    """A multi-track layout with resets and a batch mixing full-length
    and clipped reads, laid out as the pipeline does; the reference is
    padded to a multiple of 3*TD so it splits into three segments."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(20, 120, size=int(rng.integers(2, 5)))
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in sizes]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=TD, align=W)
    qlens = [W, 11, W - 5, W, 1, W] if clipped else [W] * 6
    qlist = [rng.standard_normal(n).astype(np.float32) for n in qlens]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=Q)
    qb_k, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
    ypad, rspad, D = layout.prepare_wavefront_inputs(ref, reset, Q, td=3 * TD)
    return qb_k, fs, ypad, rspad, W - 1


def test_chunk_segment_diags_alignment():
    for W in (250, 500, 48, 251, 1):
        Ds = cr.chunk_segment_diags(W)
        assert Ds % W == 0 and Ds % 32 == 0, (W, Ds)
    # the JAX package's segment at its default 256-diagonal tile
    assert cr.chunk_segment_diags(250) == 32_000
    assert cr.chunk_segment_diags(64, target=256) == 256


@pytest.mark.parametrize("clipped,std", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_carry_state_bitwise_vs_pallas(seed, clipped, std):
    """Chained over >= 3 segments: the scores and the four outgoing
    state tensors equal the JAX carry kernel's after every segment."""
    qb, fs, ypad, rspad, lane = _case(seed, clipped=clipped)
    B, Q = qb.shape
    n_seg = ypad.shape[1] // TD
    assert n_seg >= 3
    js = tuple(jnp.asarray(a) for a in _fresh(B, Q))
    ts = tuple(torch.from_numpy(a) for a in _fresh(B, Q))
    before = wf.sdtw_wavefront_carry.launches
    for s in range(n_seg):
        yp, rp = ypad[:, s * TD : (s + 1) * TD], rspad[:, s * TD : (s + 1) * TD]
        jout = jax_carry(
            jnp.asarray(qb), jnp.asarray(yp), jnp.asarray(rp), *js, lane=lane,
            td=TD, unroll=4, interpret=True, start_lanes=jnp.asarray(fs), std=std,
        )
        tout = wf.sdtw_wavefront_carry(
            torch.from_numpy(qb), torch.from_numpy(yp), torch.from_numpy(rp), *ts,
            lane, start_lanes=torch.from_numpy(fs), std=std,
        )
        for name, j, t in zip(("scores", "a1", "a2", "ywin", "rswin"), jout, tout):
            assert t.dtype == torch.float32 and tuple(t.shape) == tuple(j.shape), name
            np.testing.assert_array_equal(_bits(t.numpy()), _bits(j), err_msg=f"{name}, segment {s}")
        js, ts = tuple(jout[1:]), tuple(tout[1:])
    assert wf.sdtw_wavefront_carry.launches == before  # CPU: no kernel launch


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("seg", [TD, 40, 1])
def test_carry_chain_equals_one_pass(seg, std):
    """Segments of any length, chained, give one pass's scores bitwise."""
    qb, fs, ypad, rspad, lane = _case(5)
    q, y, r, sl = (torch.from_numpy(a) for a in (qb, ypad, rspad, fs))
    want = wf.wavefront_plain(q, y, r, lane, sl, std)
    D = y.shape[1]
    if seg == 1:
        seg = D // 3 + 1  # three uneven segments
    state = tuple(torch.from_numpy(a) for a in _fresh(*q.shape))
    got = []
    for o in range(0, D, seg):
        sc, *state = wf.sdtw_wavefront_carry(
            q, y[:, o : o + seg], r[:, o : o + seg], *state, lane, sl, std,
        )
        got.append(sc)
    np.testing.assert_array_equal(_bits(torch.cat(got, dim=1).numpy()), _bits(want.numpy()))


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_carry_state_outside_the_mask_is_never_read(seed, std):
    """What carry_state_mask leaves out of the state (rows below a read's
    start lane) may hold anything: the JAX carry kernel, fed garbage
    there, returns the same scores and the same state under the mask.
    That is what lets the split CUDA kernel's state differ there, and
    lets a chain mix warp counts."""
    qb, fs, ypad, rspad, lane = _case(seed)
    B, Q = qb.shape
    assert fs.max() > 1, "want clipped reads"

    def segment(s, state):
        return jax_carry(
            jnp.asarray(qb), jnp.asarray(ypad[:, s * TD : (s + 1) * TD]),
            jnp.asarray(rspad[:, s * TD : (s + 1) * TD]), *(jnp.asarray(a) for a in state),
            lane=lane, td=TD, unroll=4, interpret=True, start_lanes=jnp.asarray(fs), std=std,
        )

    masks = [m.numpy() for m in wf.carry_state_mask(torch.from_numpy(fs), B, Q)]
    state = [np.asarray(a) for a in segment(0, _fresh(B, Q))[1:]]
    rng = np.random.default_rng(seed + 20)
    noisy = [np.where(m, a, rng.standard_normal(a.shape).astype(np.float32) * 1e3)
             for a, m in zip(state, masks)]
    assert any((n != a).any() for n, a in zip(noisy, state))
    want, got = segment(1, state), segment(1, noisy)
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    for name, g, w, m in zip(("a1", "a2", "ywin", "rswin"), got[1:], want[1:], masks):
        np.testing.assert_array_equal(_bits(np.asarray(g)[m]), _bits(np.asarray(w)[m]), err_msg=name)


def test_plain_carry_arguments_all_or_none():
    qb, _, ypad, rspad, lane = _case(2)
    q, y, r = (torch.from_numpy(a) for a in (qb, ypad, rspad))
    a1 = torch.from_numpy(_fresh(*qb.shape)[0])
    with pytest.raises(ValueError, match="all four"):
        wf.wavefront_plain(q, y, r, lane, a1=a1)
    with pytest.raises(ValueError, match="ywin"):
        wf.sdtw_wavefront_carry(q, y, r, a1, a1, a1, a1, lane)


def _top5_case(seed, W=48, Q=64):
    """Tracks and a batch with planted near-ties: rows 1 and 2 repeat
    row 0, and a repeated reference stretch makes equal costs in several
    windows, across segment boundaries (the pattern of
    tests/test_chunked_ref.py)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(30, 200, size=4)
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in sizes]
    tracks[1][: 40] = tracks[0][: 40]
    ref, reset, offsets = layout.pad_tracks(tracks, ckpt=32, align=W)
    R = ref.shape[0]
    _, valid = layout.build_column_maps(offsets, R, track_sizes=[t.size for t in tracks])
    qlist = [rng.standard_normal(W).astype(np.float32) for _ in range(6)]
    qlist[1] = qlist[0].copy()
    qlist[2] = tracks[0][: W].copy()
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=Q)
    return ref, reset, valid, qb, qlens, W, Q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_top5_bitwise_vs_pallas(seed):
    """The port's fold and top-5 against the JAX package's, packed
    buffers bitwise, and against the one-shot plain kernel + window_top5."""
    ref, reset, valid, qb, qlens, W, Q = _top5_case(seed)
    R = ref.shape[0]
    yps, rps, vs, Ds, nwin = cr.prepare_chunked_inputs(ref, reset, valid, Q, W, target=TD)
    jy, jr, jv, jDs, jnwin = jax_prepare_chunked(ref, reset, valid, Q, W, td=TD, target=TD)
    assert yps.shape[0] >= 3, "want several segments for the fold"
    assert (Ds, nwin) == (jDs, jnwin)
    for a, b in ((yps, jy), (rps, jr), (vs, jv)):
        assert np.array_equal(a, b)
    want = np.asarray(jax_chunked_top5(
        jnp.asarray(qb), jnp.asarray(yps), jnp.asarray(rps), jnp.asarray(vs),
        lane=W - 1, W=W, nwin_tot=nwin, td=TD, unroll=4, interpret=True,
    ))
    before = wf.sdtw_wavefront_carry.launches
    got = cr.sdtw_wavefront_chunked_top5(
        torch.from_numpy(qb), torch.from_numpy(yps), torch.from_numpy(rps),
        torch.from_numpy(vs), W - 1, W, nwin,
    )
    assert wf.sdtw_wavefront_carry.launches == before
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the one-shot route gives the same bytes
    ypad, rspad, _ = layout.prepare_wavefront_inputs(ref, reset, Q)
    scores = wf.sdtw_wavefront(torch.from_numpy(qb), torch.from_numpy(ypad),
                               torch.from_numpy(rspad), W - 1)
    one = window_top5(scores, torch.from_numpy(valid), R, W, pack=True)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(one.numpy()))
    # and so does the JAX package's own one-shot top-5 (ties and all)
    jone = device_window_top5(
        jnp.asarray(scores.numpy()), jnp.asarray(qlens.astype(np.int32)),
        jnp.asarray(valid), R, W=W, k=5, reindex=True, pack=True,
    )
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(np.asarray(jone)))


# ------------------------------------------------------------ clip fold

W_CLIP = 48
TD_CLIP = 96  # chunk_segment_diags(48, target=96): segments of 96 diagonals


def _clip_case(seed, qset, sizes=None):
    """Several tracks, one of them (a contig, not the first) shorter than
    every qlen but 1, and a batch of full-length reads and clipped reads of the qlens in
    `qset`, shifted for the kernel. Returns a dict of the host arrays."""
    W = W_CLIP
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = [int(x) for x in rng.integers(40, 260, size=4)]
        sizes[int(rng.integers(1, 4))] = 5
    tracks = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    long = [t for t in tracks[1:] if t.size >= 30]
    if long:
        long[0][:30] = tracks[0][:30]  # equal costs in several windows
    ref, reset, offsets = layout.pad_tracks(tracks, ckpt=32, align=W)
    R = ref.shape[0]
    u, valid = layout.build_column_maps(offsets, R, track_sizes=sizes)
    qlens = [W, *qset, W, *qset[::-1]]
    qlist = [rng.standard_normal(n).astype(np.float32) for n in qlens]
    qlist[1] = tracks[0][: qlens[1]].copy()
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=64)
    qb_k, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
    yps, rps, vs, Ds, nwin = cr.prepare_chunked_inputs(ref, reset, valid, 64, W, target=TD_CLIP)
    ts, ls = cr.prepare_clip_inputs(offsets, sizes, W, vs.shape[0], Ds)
    rows = np.where((qlens > 0) & (qlens != W))[0]
    return dict(ref=ref, reset=reset, R=R, u=u, valid=valid, sizes=sizes, qb=qb, qlens=qlens,
                qb_k=qb_k, fs=fs, yps=yps, rps=rps, vs=vs, Ds=Ds, nwin=nwin, ts=ts, ls=ls,
                rows=rows)


def _clip_fold(c, rows=None):
    """A ClipFold over the case's clipped rows (read at `rows` of the
    chain, by default their own rows)."""
    r = c["rows"]
    bases, n_win = cr.clip_window_bases(c["sizes"], c["qlens"][r])
    return cr.ClipFold(
        torch.from_numpy(r if rows is None else rows), torch.from_numpy(c["qlens"][r]),
        torch.from_numpy(bases), n_win, torch.from_numpy(c["ts"]), torch.from_numpy(c["ls"]),
        torch.from_numpy(c["vs"]), W_CLIP)


def _fold_blocks(fold, lastrow_diag, c):
    """Feed a fold the segments of a diagonal-indexed (B, D) score row,
    one (B, Ds) block at a time (diagonals past D score BIG)."""
    S, Ds = c["vs"].shape
    full = torch.full((lastrow_diag.shape[0], S * Ds), BIG)
    n = min(S * Ds, lastrow_diag.shape[1])
    full[:, :n] = lastrow_diag[:, :n]
    for s in range(S):
        fold.update(s, full[:, s * Ds : (s + 1) * Ds])
    return fold.top5()


def _topk_both(lr, c):
    """topk_candidates(reindex=False, pack=True) of the clipped rows'
    (n, R) last rows, the port's and the JAX package's, as int32 bits."""
    r, R = c["rows"], c["R"]
    port = topk_candidates(torch.from_numpy(lr), torch.from_numpy(c["qlens"][r]),
                           torch.from_numpy(c["u"]), torch.from_numpy(c["valid"]), R,
                           reindex=False, pack=True)
    jax = device_topk_candidates(
        jnp.asarray(lr), jnp.asarray(c["qlens"][r]), jnp.asarray(c["u"]),
        jnp.asarray(c["valid"]), R, W=W_CLIP, k=5, reindex=False, pack=True)
    return _bits(port.numpy()), _bits(np.asarray(jax))


@pytest.mark.parametrize("qset", [(7, 25, W_CLIP - 1, 31), (29, 7, 16, 25, W_CLIP - 1, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_clip_fold_bitwise_vs_topk_candidates(seed, qset):
    """The clip fold equals topk_candidates over the one-shot row, bit for
    bit, the port's and the JAX package's: fed the JAX kernel's one-shot
    scores (interpret mode) segment by segment, and inside the carry
    chain beside the W-window fold. qlens 7, 25, W-1 and 31 or 29 (which
    divide neither W=48 nor Ds=96), a contig shorter than qlen."""
    c = _clip_case(seed, qset)
    S, Ds = c["vs"].shape
    assert S >= 3 and min(c["sizes"]) < min(q for q in qset if q > 1)
    W, R, r = W_CLIP, c["R"], c["rows"]
    ypad, rspad, _ = layout.prepare_wavefront_inputs(c["ref"], c["reset"], 64)
    one = np.asarray(jax_wavefront(
        jnp.asarray(c["qb_k"]), jnp.asarray(ypad), jnp.asarray(rspad), lane=W - 1, td=32,
        unroll=4, interpret=True, start_lanes=jnp.asarray(c["fs"])))
    port_want, jax_want = _topk_both(np.ascontiguousarray(one[r, W - 1 : W - 1 + R]), c)
    np.testing.assert_array_equal(port_want, jax_want)

    got = _fold_blocks(_clip_fold(c, rows=np.arange(r.size)), torch.from_numpy(one[r]), c)
    np.testing.assert_array_equal(_bits(got.numpy()), port_want)

    fold = _clip_fold(c)
    window = cr.WindowFold(c["qb"].shape[0], torch.from_numpy(c["vs"]), W, c["nwin"])
    cr.carry_chain(torch.from_numpy(c["qb_k"]), torch.from_numpy(c["yps"]),
                   torch.from_numpy(c["rps"]), W - 1, [window, fold], torch.from_numpy(c["fs"]))
    np.testing.assert_array_equal(_bits(fold.top5().numpy()), port_want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_fold_planted_ties(seed):
    """Small-integer scores full of ties, with equal minima planted on
    both sides of every segment boundary and at both edges of windows,
    and reads (qlen 47 on tracks of 60 and 5 columns: 2 + 1 windows) with
    fewer than k real windows: the fold equals both packages' topk_candidates."""
    c = _clip_case(seed, (7, 25, W_CLIP - 1, 31), sizes=[60, 5] if seed == 2 else None)
    S, Ds = c["vs"].shape
    W, R, r = W_CLIP, c["R"], c["rows"]
    rng = np.random.default_rng(seed + 40)
    diag = rng.integers(1, 4, size=(r.size, S * Ds)).astype(np.float32)
    for s in range(1, S):
        diag[:, s * Ds - 2 : s * Ds + 2] = 0.0  # the boundary's last and first columns
    for b, q in enumerate(c["qlens"][r]):
        diag[b, W - 1 :: int(q)] = 0.0  # every window's first column ...
        diag[b, W - 2 + int(q) :: int(q)] = 0.0  # ... and its last
    port_want, jax_want = _topk_both(np.ascontiguousarray(diag[:, W - 1 : W - 1 + R]), c)
    np.testing.assert_array_equal(port_want, jax_want)
    got = _fold_blocks(_clip_fold(c, rows=np.arange(r.size)), torch.from_numpy(diag), c)
    np.testing.assert_array_equal(_bits(got.numpy()), port_want)
    if seed == 2:
        pos = got.numpy()[:, 5:].view(np.int32)
        few = c["qlens"][r] == W - 1
        assert (pos[few, 3:] == -1).all() and (pos[few, :3] >= 0).all(), "3 real windows"


@pytest.mark.parametrize("seed", [0, 1])
def test_full_rows_unchanged_beside_clipped_rows(seed):
    """Layout (a): the clipped rows share the batch's chain, whose every
    launch then takes start lanes (full-length rows at lane 0). The
    full-length rows' packed W-window results equal, bit for bit, those
    of a chain of full-length rows alone without start lanes."""
    c = _clip_case(seed, (7, 25, W_CLIP - 1, 31))
    W = W_CLIP
    full = np.where(c["qlens"] == W)[0]
    vs = torch.from_numpy(c["vs"])
    mixed = cr.WindowFold(c["qb"].shape[0], vs, W, c["nwin"])
    cr.carry_chain(torch.from_numpy(c["qb_k"]), torch.from_numpy(c["yps"]),
                   torch.from_numpy(c["rps"]), W - 1, [mixed, _clip_fold(c)],
                   torch.from_numpy(c["fs"]))
    alone = cr.sdtw_wavefront_chunked_top5(
        torch.from_numpy(c["qb"][full]), torch.from_numpy(c["yps"]), torch.from_numpy(c["rps"]),
        vs, W - 1, W, c["nwin"])
    np.testing.assert_array_equal(_bits(mixed.top5().numpy()[full]), _bits(alone.numpy()))


def test_clip_window_bases_cache():
    """The window numbering per qlen: ceil(len / qlen) windows per track,
    numbered in track order; a cached qlen returns the same numbering."""
    cache = {}
    bases, most = cr.clip_window_bases([10, 3, 0, 7], np.array([4, 3, 4], np.int32), cache)
    np.testing.assert_array_equal(bases, [[0, 3, 4, 4], [0, 4, 5, 5], [0, 3, 4, 4]])
    assert most == 8 and sorted(cache) == [3, 4]
    again, _ = cr.clip_window_bases([10, 3, 0, 7], np.array([3], np.int32), cache)
    np.testing.assert_array_equal(again, bases[1:2])


# ---------------------------------------------------------------- pipeline

W_PIPE = 64
N_BASES = 3000


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """One 3,000-base contig and a BLOW5 of 8 reads: 6 full-length, 2
    clipped (fewer events than prefix + query), both strands."""
    from sigfish_tpu_torch.io.blow5 import Slow5Record, Slow5Writer
    from sigfish_tpu_torch.models.genref import _seq_bytes, kmer_ranks, reverse_complement
    from sigfish_tpu_torch.models.pore_model import MODEL_ID_DNA_R9, load_builtin_model

    d = tmp_path_factory.mktemp("torch_chunked")
    rng = np.random.default_rng(7)
    model = load_builtin_model(MODEL_ID_DNA_R9)
    k = model.kmer_size
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, N_BASES))
    rc = reverse_complement(seq)
    fa = d / "ref.fa"
    fa.write_text(f">synth1\n{seq}\n")

    def signal_from(src, start, n_events):
        sub = src[start : start + n_events + k - 1]
        levels = model.level_mean[kmer_ranks(_seq_bytes(sub), k, warn_non_acgt=False)]
        pa = np.repeat(levels, rng.integers(9, 15, size=levels.size)).astype(np.float64)
        pa += rng.normal(0.0, 1.2, pa.size)
        return np.clip(np.rint(pa * 8192.0 / 1400.0 - 10.0), -32000, 32000).astype(np.int16)

    bl = d / "reads.blow5"
    with Slow5Writer(str(bl), header_data=None) as w:
        for i in range(8):
            n_ev = 45 if i in (3, 6) else 300
            src = seq if i % 2 else rc
            sig = signal_from(src, int(rng.integers(0, N_BASES - 600)), n_ev)
            w.write_record(Slow5Record(
                read_id=f"r{i}", read_group=0, digitisation=8192.0, offset=10.0,
                range=1400.0, sampling_rate=4000.0, raw_signal=sig,
            ))
    return str(fa), str(bl)


def _run_port(fa, bl, ref_chunk, **kw) -> tuple[str, dict]:
    """The port's PAF, and how often each device route ran."""
    from sigfish_tpu_torch.runtime.pipeline import Core, Options, run_dtw

    core = Core(fa, bl, Options(query_size=W_PIPE, batch_size=8, num_thread=2,
                                device="cpu", ref_chunk=ref_chunk, **kw))
    out = io.StringIO()
    run_dtw(core, out)
    core.close()
    return out.getvalue(), core.routes


@pytest.fixture(scope="module")
def oneshot_paf(workload):
    paf, routes = _run_port(*workload, ref_chunk=-1)
    assert routes["chunked"] == 0 and routes["oneshot"] > 0
    return paf


@pytest.mark.parametrize("clip_budget", [None, 0])
def test_chunked_pipeline_paf_vs_jax(workload, oneshot_paf, clip_budget, monkeypatch):
    """Forced small segments: the port's PAF equals the JAX package's
    (pallas engine, same forced chunking) and the port's one-shot PAF.
    The JAX package serves its clipped reads through one-shot clip groups
    at its default clip budget (None) and through its host per-read DP at
    0; the port serves them through the carry chain's clip fold either
    way, with no one-shot launch."""
    from sigfish_tpu.runtime import pipeline as jpl
    from sigfish_tpu_torch.runtime import pipeline as tpl

    if clip_budget is not None:
        monkeypatch.setattr(jpl, "_CLIP_ONESHOT_BYTES", clip_budget)
    monkeypatch.setattr(tpl, "sdtw_wavefront", _no_oneshot)
    fa, bl = workload
    Ds = cr.chunk_segment_diags(W_PIPE, target=256)
    assert 2 * (N_BASES + 1 - 6) + 128 > 2 * Ds, "want >= 2 segments"

    before = wf.sdtw_wavefront_carry.launches
    got, routes = _run_port(fa, bl, ref_chunk=256)
    assert wf.sdtw_wavefront_carry.launches == before  # the CPU runs the plain version
    assert routes["chunked"] > 0 and routes["clip_fold"] > 0 and routes["oneshot"] == 0

    jcore = jpl.Core(fa, bl, jpl.Options(engine="pallas", num_thread=2, ref_chunk=256,
                                         query_size=W_PIPE, batch_size=8))
    out = io.StringIO()
    jpl.run_dtw(jcore, out)
    jcore.close()
    assert got == out.getvalue()
    assert got == oneshot_paf
    ids = {ln.split("\t")[0] for ln in got.splitlines()}
    assert {"r3", "r6"} & ids, "a clipped read is mapped"
    assert len(ids) >= 6


def test_chunked_batch_of_clipped_reads_only(workload, monkeypatch):
    """A batch whose every live row is clipped runs one chain with start
    lanes and the clip fold alone (no W-window fold); it gives the
    one-shot route's candidates."""
    from sigfish_tpu_torch.runtime import pipeline as tpl

    seen = _spy_chains(tpl, monkeypatch)
    core = tpl.Core(*workload, tpl.Options(query_size=W_PIPE, device="cpu", ref_chunk=256))
    rng = np.random.default_rng(11)
    qlist = [rng.standard_normal(n).astype(np.float32) for n in (20, W_PIPE - 1, 33, 7)]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=core.pad_q)
    got = core.sdtw_candidates_collect(core.sdtw_candidates_submit(qb, qlens))
    assert core.routes == {"oneshot": 0, "clip_pass": 0, "chunked": 1, "clip_fold": 1,
                           "mesh_tracks": 0, "ring": 0}
    assert seen == [(4, True, ["ClipFold"])]
    want = core.sdtw_candidates_collect(core.sdtw_candidates_submit(qb, qlens, force_oneshot=True))
    core.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1][:, 0] >= 0).all()


def _spy_chains(tpl, monkeypatch) -> list:
    """Record (rows, start lanes given, fold types) of each carry chain
    the pipeline runs."""
    seen = []
    real = tpl.carry_chain

    def spy(queries, ypad_seg, rspad_seg, lane, folds, start_lanes=None, **kw):
        seen.append((queries.shape[0], start_lanes is not None,
                     [type(f).__name__ for f in folds]))
        return real(queries, ypad_seg, rspad_seg, lane, folds, start_lanes, **kw)

    monkeypatch.setattr(tpl, "carry_chain", spy)
    return seen


@pytest.mark.parametrize("num_thread", [1, 2])
def test_chunked_clipped_rows_ride_the_batch_chain(workload, oneshot_paf, num_thread, monkeypatch):
    """The clipped rows ride the batch's own chain (every launch with
    start lanes, both folds) and map the one-shot route's bytes, with the
    host stages serial or overlapped; each batch with clipped rows
    counts once."""
    from sigfish_tpu_torch.runtime import pipeline as tpl

    monkeypatch.setattr(tpl, "sdtw_wavefront", _no_oneshot)
    seen = _spy_chains(tpl, monkeypatch)
    core = tpl.Core(*workload, tpl.Options(query_size=W_PIPE, batch_size=8, num_thread=num_thread,
                                           device="cpu", ref_chunk=256))
    out = io.StringIO()
    tpl.run_dtw(core, out)
    core.close()
    assert out.getvalue() == oneshot_paf
    assert core.routes["clip_fold"] == 1 and core.routes["chunked"] == 1
    assert seen == [(64, True, ["WindowFold", "ClipFold"])]


def _no_oneshot(*args, **kw):
    raise AssertionError("the chunked route launched the one-shot kernel")


def test_oneshot_submissions_hold_their_buffers_one_at_a_time(workload, monkeypatch):
    """Threads that submit one-shot batches at once (force_oneshot): one
    one-shot submission at a time runs the kernel and holds its (rows, D)
    buffers, so two submissions' buffers never meet; each thread's
    candidates are unchanged."""
    import threading
    import time

    from sigfish_tpu_torch.runtime import pipeline as tpl

    guard, inside, most = threading.Lock(), [0], [0]
    real = tpl.sdtw_wavefront

    def slow(*args, **kw):
        with guard:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        time.sleep(0.05)
        try:
            return real(*args, **kw)
        finally:
            with guard:
                inside[0] -= 1

    monkeypatch.setattr(tpl, "sdtw_wavefront", slow)
    core = tpl.Core(*workload, tpl.Options(query_size=W_PIPE, device="cpu", ref_chunk=256))
    rng = np.random.default_rng(13)
    qlist = [rng.standard_normal(n).astype(np.float32) for n in (20, 33)]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=core.pad_q)
    handles = [None] * 4

    def submit(i):
        handles[i] = core.sdtw_candidates_submit(qb, qlens, force_oneshot=True)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = [core.sdtw_candidates_collect(h) for h in handles]
    core.close()
    assert most[0] == 1
    for g in got[1:]:
        for a, b in zip(g, got[0]):
            np.testing.assert_array_equal(a, b)


def test_clip_budget_below_one_row_raises_on_the_card(workload, monkeypatch):
    """The chunked route consults no byte budget and raises for no
    reference size: it holds no buffer as wide as the reference, so a
    clipped read maps at any size. Every tensor an op makes while it
    serves a batch of one full-length and one clipped read is narrower
    than the reference's R columns (the one-shot clip pass's (rows, R)
    and (rows, D) buffers are not), and its candidates are the one-shot
    route's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from sigfish_tpu_torch.runtime import pipeline as tpl

    assert not hasattr(tpl, "_CLIP_ONESHOT_BYTES") and not hasattr(tpl, "_LATER")

    class Widest(TorchDispatchMode):
        widest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dim():
                    Widest.widest = max(Widest.widest, max(t.shape))
            return out

    core = tpl.Core(*workload, tpl.Options(query_size=W_PIPE, device="cpu", ref_chunk=256))
    R = core.ref_cat.shape[0]
    rng = np.random.default_rng(12)
    qlist = [rng.standard_normal(n).astype(np.float32) for n in (W_PIPE, 20)]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=core.pad_q)
    core._chunk_inputs(qb.shape[1])  # the reference's own segment buffers, made once
    with Widest():
        got = core.sdtw_candidates_collect(core.sdtw_candidates_submit(qb, qlens))
    assert core.routes["clip_fold"] == 1
    assert 0 < Widest.widest < R, (Widest.widest, R)
    want = core.sdtw_candidates_collect(core.sdtw_candidates_submit(qb, qlens, force_oneshot=True))
    core.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_auto_route_past_threshold(workload, oneshot_paf, monkeypatch):
    """ref_chunk=0 takes the chunked route once R + Q passes
    CHUNK_AUTO_COLS, with the same bytes; ref_chunk=-1 never does."""
    from sigfish_tpu_torch.runtime import pipeline as tpl

    monkeypatch.setattr(tpl, "CHUNK_AUTO_COLS", 1024)
    paf, routes = _run_port(*workload, ref_chunk=0)
    assert paf == oneshot_paf
    assert routes["chunked"] > 0
    paf, routes = _run_port(*workload, ref_chunk=-1)
    assert paf == oneshot_paf
    assert routes["chunked"] == 0


def test_cli_ref_chunk(workload, oneshot_paf, tmp_path):
    """`python -m sigfish_tpu_torch.cli dtw ... --ref-chunk N --device
    cpu` writes the library's bytes."""
    fa, bl = workload
    out = tmp_path / "out.paf"
    r = subprocess.run(
        [sys.executable, "-m", "sigfish_tpu_torch.cli", "dtw", fa, bl,
         "-q", str(W_PIPE), "-K", "8", "-t", "2", "--device", "cpu",
         "--ref-chunk", "256", "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert out.read_text() == oneshot_paf


def _flag_free_brute(rspad_seg: np.ndarray, Q: int) -> list[bool]:
    """flag_free_segments by a scan of every column each segment reads:
    its own diagonals and the Q-1 before them (none before column 0)."""
    S, _, Ds = rspad_seg.shape
    flat = rspad_seg.reshape(-1)
    return [not any(flat[c] > 0.5 for c in range(max(0, s * Ds - (Q - 1)), (s + 1) * Ds))
            for s in range(S)]


@pytest.mark.parametrize("Q", [64, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flag_free_segments_vs_brute_force(seed, Q):
    """The per-segment flag table against a scan of rspad: flags at a
    segment's first and last diagonal, Q-1 and Q diagonals before a
    segment's first (inside and just outside its window), and at
    random."""
    rng = np.random.default_rng(seed)
    S, Ds = 12, 320
    rs = np.zeros(S * Ds, dtype=np.float32)
    rs[3 * Ds] = 1.0                     # segment 3's first diagonal
    rs[6 * Ds - 1] = 1.0                 # segment 5's last: segment 6 sees it
    rs[8 * Ds - (Q - 1)] = 1.0           # inside segment 8's window
    rs[11 * Ds - Q] = 1.0                # just outside segment 11's window
    rs[rng.integers(0, S * Ds, size=2)] = 1.0
    seg = rs.reshape(S, 1, Ds)
    got = cr.flag_free_segments(seg, Q)
    assert got.dtype == bool and got.shape == (S,)
    assert got.tolist() == _flag_free_brute(seg, Q)
    assert not got[3] and not got[5] and not got[6] and not got[8]
    # the layout of prepare_chunked_inputs: track starts and the PAD flush
    qb, fs, ypad, rspad, lane = _case(seed, W=32, Q=Q)
    ref = ypad[0][rspad[0] < 2]
    reset = rspad[0] > 0.5
    yps, rps, vs, Ds2, _ = cr.prepare_chunked_inputs(ref, reset, np.ones(ref.size, bool), Q, 32,
                                                      target=64)
    assert cr.flag_free_segments(rps, Q).tolist() == _flag_free_brute(rps, Q)


@pytest.mark.parametrize("clipped", [False, True])
def test_carry_chain_flag_free_bitwise(clipped):
    """carry_chain with the flag table gives the chain without it, bit
    for bit (the CPU wrapper checks each flags=False launch's promise),
    and counts each body's launches."""
    rng = np.random.default_rng(4)
    tracks = [rng.standard_normal(n).astype(np.float32) for n in (500, 300, 700)]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=TD, align=32)
    qlens = [32, 11, 27, 32, 1, 32] if clipped else [32] * 6
    qb, qlens, _ = layout.make_query_batch(
        [rng.standard_normal(n).astype(np.float32) for n in qlens], pad_q=64)
    qb, fs = layout.shift_queries_for_clip(qb, qlens, 31)
    lane = 31
    yps, rps, vs, Ds, nwin = cr.prepare_chunked_inputs(ref, reset, np.ones(ref.size, bool), 64, 32,
                                                       target=64)
    table = cr.flag_free_segments(rps, 64)
    assert table.any() and not table.all()
    B = qb.shape[0]
    t = torch.from_numpy
    sl = t(fs) if clipped else None
    folds = [cr.WindowFold(B, t(vs), 32, nwin), cr.WindowFold(B, t(vs), 32, nwin)]
    got = cr.carry_chain(t(qb), t(yps), t(rps), lane, folds[:1], sl, flag_free=table.tolist())
    assert got == {"noflag": int(table.sum()), "flag": int((~table).sum())}
    assert cr.carry_chain(t(qb), t(yps), t(rps), lane, folds[1:], sl) == {
        "noflag": 0, "flag": table.size}
    np.testing.assert_array_equal(folds[0].top5().numpy(), folds[1].top5().numpy())


def test_auto_route_counts_carry_bodies(workload, oneshot_paf, monkeypatch):
    """The chunked route, auto (ref_chunk=0) or forced, runs each segment
    that flag_free_segments clears with the flag-free body and the rest
    flag-aware, with the one-shot route's bytes; Core.counts has each
    body's launches."""
    from sigfish_tpu_torch.runtime import pipeline as tpl
    from sigfish_tpu_torch.runtime.pipeline import Core, Options, run_dtw

    real = tpl.prepare_chunked_inputs
    monkeypatch.setattr(tpl, "CHUNK_AUTO_COLS", 1024)
    monkeypatch.setattr(tpl, "prepare_chunked_inputs",
                        lambda *a, target=None: real(*a, target=256))
    for ref_chunk in (0, 256):
        core = Core(*workload, Options(query_size=W_PIPE, batch_size=8, num_thread=2,
                                       device="cpu", ref_chunk=ref_chunk))
        out = io.StringIO()
        run_dtw(core, out)
        core.close()
        assert out.getvalue() == oneshot_paf
        c = core.counts
        table = core._chunk_inputs(core.pad_q)[-1]
        chains = core.routes["chunked"]
        assert chains > 0 and c["carry_noflag"] + c["carry_flag"] == chains * len(table)
        assert c["carry_noflag"] == chains * sum(table) > 0 and c["carry_flag"] > 0
