"""The scan engine and the engine choice on the CPU: the port's column
scan (sigfish_tpu_torch/ops/sdtw_scan.py, the plain version of
csrc/scan.cu) against sigfish_tpu.ops.sdtw.sdtw_scan and the exact DP,
and whole runs under --engine / --accel against sigfish_tpu's.

The two scans sum each column in different orders (the port's is the
kernel's: runs of Q/32 rows, then a Hillis-Steele scan of the run
totals; XLA's is its own), so their last rows agree within the JAX
package's tolerance for this engine (rtol 2e-5, atol 2e-4,
tests/test_sdtw.py), not bit for bit. Where two windows' scores lie
within that drift a row's winner can differ between the two, as it can
between either scan and the exact engines (the scan's documented
deviation, sigfish_tpu/ops/sdtw.py): _scan_flips finds those reads from
the two packages' candidates on the same batch and checks that each is
such a near-tie in both packages' own rows; every other read's PAF line
is byte-identical. The wavefront and native engines are exact, and
their PAFs are byte-identical outright.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from port_runs import load_smoke, run_jax, run_port
from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops import sdtw_ref
from sigfish_tpu_torch.ops import sdtw_scan as ss

RTOL, ATOL = 2e-5, 2e-4   # the JAX package's tolerance for its scan engine
BIG = np.float32(3.0e38)


def _batch(seed, W, Q, sizes, n, clip=True):
    """A padded layout of random tracks and n queries (every other one
    clipped to 25..W-1 with clip=True; one of qlen 0)."""
    rng = np.random.default_rng(seed)
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in sizes]
    ref, reset, offs = layout.pad_tracks(tracks, ckpt=512, align=W)
    qlens = np.full(n, W)
    if clip:
        qlens[1::2] = rng.integers(25, W, size=qlens[1::2].size)
    qlens[-1] = 0
    qs = [rng.standard_normal(int(q)).astype(np.float32) for q in qlens]
    qb, ql, oh = layout.make_query_batch(qs, pad_q=Q)
    return tracks, offs, qs, (qb, oh, ref, reset)


def _jax_scan(qb, oh, ref, reset, std):
    import jax.numpy as jnp

    from sigfish_tpu.ops.sdtw import sdtw_scan

    return np.asarray(sdtw_scan(jnp.asarray(qb), jnp.asarray(oh), jnp.asarray(ref),
                                jnp.asarray(reset), ckpt=512, std=std))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("W,Q", [(100, 128), (250, 256), (500, 512)])
def test_scan_plain_matches_jax_scan_and_exact_dp(W, Q, std):
    """One-shot over tracks with resets, clipped qlens and a qlen-0 row:
    within the JAX tolerance of sigfish_tpu's sdtw_scan everywhere, of
    the exact DP (the port's sdtw_ref) on every track, and 0 on the
    qlen-0 row, as the JAX one-hot sum gives."""
    tracks, offs, qs, (qb, oh, ref, reset) = _batch(W + Q, W, Q, (700, 40, 300), 6)
    got, final = ss.scan_plain(*(torch.from_numpy(a) for a in (qb, oh, ref, reset)), std=std)
    got = got.numpy()
    assert final.shape == qb.shape
    np.testing.assert_allclose(got, _jax_scan(qb, oh, ref, reset, std), rtol=RTOL, atol=ATOL)
    exact = sdtw_ref.std_dtw_cost if std else sdtw_ref.subsequence_cost
    for b, q in enumerate(qs):
        if not q.size:
            assert (got[b] == 0).all()
            continue
        for t, tr in enumerate(tracks):
            o = int(offs[t])
            np.testing.assert_allclose(got[b, o : o + tr.size], exact(q, tr)[-1],
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("cuts", [(37, 600), (1, 512, 513), (900,)])
def test_scan_carry_chain_is_the_one_shot_bitwise(std, cuts):
    """Uneven segments, each started from the previous one's final
    column, give the one-shot scan's rows and final column bit for bit
    (resets inside and on the segment edges)."""
    _, _, _, (qb, oh, ref, reset) = _batch(3, 250, 256, (300, 450, 50), 5)
    args = [torch.from_numpy(a) for a in (qb, oh)]
    y, r = torch.from_numpy(ref), torch.from_numpy(reset)
    want, want_final = ss.scan_plain(*args, y, r, std=std)
    init, parts = None, []
    for a, b in zip((0, *cuts), (*cuts, ref.size)):
        lr, init = ss.scan_plain(*args, y[a:b], r[a:b], std=std, init=init)
        parts.append(lr)
    assert np.array_equal(_bits(torch.cat(parts, 1)), _bits(want))
    assert np.array_equal(_bits(init), _bits(want_final))


def _numpy_scan(qb, oh, ref, reset, std):
    """The kernel's order restated in numpy f32, column by column: each
    lane's run of Q/32 rows summed in row order, a Hillis-Steele scan of
    the 32 run totals (lane l adds lane l - off, off = 1, 2, 4, 8, 16),
    each row plus its run's exclusive prefix; then t, the prefix min and
    new = s + g."""
    B, Q = qb.shape
    r = Q // 32
    c = np.full((B, Q), BIG, np.float32)
    out = np.zeros((B, ref.size), np.float32)
    rows = [int(np.argmax(o)) if o.any() else -1 for o in oh]
    for j in range(ref.size):
        a = np.abs(qb - np.float32(ref[j])).reshape(B, 32, r)
        for k in range(1, r):
            a[:, :, k] = a[:, :, k - 1] + a[:, :, k]
        v = a[:, :, r - 1].copy()
        for off in (1, 2, 4, 8, 16):
            nv = v.copy()
            nv[:, off:] = v[:, off:] + v[:, :-off]
            v = nv
        e = np.zeros_like(v)
        e[:, 1:] = v[:, :-1]
        s = (a + e[:, :, None]).reshape(B, Q)
        p0 = np.zeros(B, np.float32) if reset[j] else c[:, 0].copy()
        if reset[j]:
            c[:] = BIG
        up = np.concatenate([np.full((B, 1), BIG, np.float32), c[:, :-1]], axis=1)
        t = np.empty((B, Q), np.float32)
        t[:, 0] = p0 if std else 0.0
        t[:, 1:] = np.minimum(c, up)[:, 1:] - s[:, :-1]
        c = s + np.minimum.accumulate(t, axis=1)
        for b, row in enumerate(rows):
            if row >= 0:
                out[b, j] = c[b, row]
    return out, c


@pytest.mark.parametrize("std", [False, True])
@pytest.mark.parametrize("Q", [64, 256])
def test_scan_order_pin(Q, std):
    """scan_plain equals the numpy restatement of the kernel's order bit
    for bit (a change of the order fails here)."""
    W = Q - 14
    _, _, _, (qb, oh, ref, reset) = _batch(Q, W, Q, (150, 90), 4)
    ref, reset = ref[:260], reset[:260]
    reset[131] = True
    want, want_c = _numpy_scan(qb, oh, ref, reset, std)
    got, got_c = ss.scan_plain(*(torch.from_numpy(a) for a in (qb, oh, ref, reset)), std=std)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(got_c), _bits(want_c))


def test_scan_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs scan_plain and launches nothing;
    an unbuilt width or a bad shape raises."""
    _, _, _, (qb, oh, ref, reset) = _batch(1, 100, 128, (200,), 3)
    args = [torch.from_numpy(a) for a in (qb, oh, ref, reset)]
    calls, launches = ss.scan_plain.calls, ss.sdtw_scan.launches
    got, _ = ss.sdtw_scan(*args, std=True)
    assert ss.scan_plain.calls == calls + 1 and ss.sdtw_scan.launches == launches
    assert np.array_equal(_bits(got), _bits(ss.scan_plain(*args, std=True)[0]))
    with pytest.raises(ValueError):
        ss.sdtw_scan(args[0][:, :100], args[1][:, :100], *args[2:])
    with pytest.raises(TypeError):
        ss.sdtw_scan(args[0], args[1], args[2], args[3].float())


# ------------------------------------------------------------ whole runs

@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


@pytest.fixture(scope="module")
def dna(smoke, tmp_path_factory):
    """chip_smoke's R9 DNA generator: 2,000 bases, 48 reads, one in ten
    clipped."""
    return smoke.make_workload(str(tmp_path_factory.mktemp("scan_dna")), 2000, 48, 15)[:2]


@pytest.fixture(scope="module")
def rna(smoke, tmp_path_factory):
    """chip_smoke's direct-RNA generator: 4 transcripts, 24 reads (adaptor,
    polyA, 3' end; clipped ones and prefix fails among them)."""
    return smoke.make_rna_workload(str(tmp_path_factory.mktemp("scan_rna")), 4, 24, 9,
                                   tx_len=(600, 1500))[:2]


RNA = dict(rna=True, query_size=500, prefix_size=-1)


def _printed(d1: float, d2: float) -> tuple:
    """What a PAF line shows of a read's two best scores: d1, d2 (%.2f)
    and the mapq."""
    from sigfish_tpu_torch.ops.candidates import compute_mapq

    d2 = float("inf") if d2 >= 1e37 else d2
    return f"{d1:.2f}", f"{d2:.2f}", compute_mapq(d1, d2)


def _scan_flips(fa, bl, **opt) -> set[str]:
    """The reads whose PAF line the two packages' scan engines may print
    differently, from one batch of every read through both Cores'
    candidate stage (the port's host stages build the queries; the two
    packages' are byte-identical): those whose winner differs, and those
    whose two best scores differ in the printed d1, d2 (%.2f) or mapq.
    Checks that the candidates' scores (or --dtw-std's corners) agree
    within the tolerance, and that each changed winner is a near-tie: in
    each package's own last row the other's winner scores within the
    tolerance of its own."""
    from sigfish_tpu.runtime import pipeline as jpl
    from sigfish_tpu_torch.runtime import pipeline as ppl

    core = ppl.Core(fa, bl, ppl.Options(device="cpu", engine="scan", num_thread=2, **opt))
    pend = ppl.submit_batch(core, core.sf.read_batch(10**6, 10**12))
    ids = [pend.works[i].rec.read_id for i in pend.live]
    qb, qlens, oh = layout.make_query_batch([pend.works[i].query for i in pend.live],
                                            pad_q=core.pad_q)
    jcore = jpl.Core(fa, bl, jpl.Options(engine="scan", num_thread=2, **opt))
    std = bool(opt.get("dtw_std"))
    try:
        if std:
            got = core.sdtw_std_corners_collect(core.sdtw_std_corners_submit(qb, qlens))
            want = np.asarray(jcore.sdtw_std_corners(qb, qlens, oh))
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            pick_p, pick_j = got.argmin(1), want.argmin(1)
            rows = [(b, pick_p[b], pick_j[b]) for b in range(len(ids)) if pick_p[b] != pick_j[b]]
            top2_p, top2_j = np.sort(got, 1)[:, :2], np.sort(want, 1)[:, :2]
            lr_p = lr_j = None
            cols = core.std_corner_cols
        else:
            ts_p, tp_p = core.sdtw_candidates_collect(core.sdtw_candidates_submit(qb, qlens))
            ts_j, tp_j = jcore.sdtw_candidates(qb, qlens, oh)
            live = (ts_p < 1e37) | (ts_j < 1e37)
            np.testing.assert_allclose(ts_p[live], ts_j[live], rtol=RTOL, atol=ATOL)
            rows = [(b, tp_p[b, 0], tp_j[b, 0]) for b in range(len(ids)) if tp_p[b, 0] != tp_j[b, 0]]
            top2_p, top2_j = ts_p[:, :2], ts_j[:, :2]
            t = [torch.from_numpy(a) for a in (qb, oh, core.ref_cat, core.reset)]
            lr_p = ss.scan_plain(*t)[0].numpy()
            lr_j = _jax_scan(qb, oh, core.ref_cat, core.reset, False)
        for b, p, j in rows:
            if std:
                a_p, a_j = got[b, p], got[b, j]
                b_p, b_j = want[b, p], want[b, j]
            else:
                a_p, a_j, b_p, b_j = lr_p[b, p], lr_p[b, j], lr_j[b, p], lr_j[b, j]
            assert abs(a_j - a_p) <= ATOL + RTOL * abs(a_p), (ids[b], p, j, a_p, a_j)
            assert abs(b_p - b_j) <= ATOL + RTOL * abs(b_j), (ids[b], p, j, b_p, b_j)
    finally:
        core.close()
        jcore.close()
    shown = {ids[b] for b in range(len(ids))
             if _printed(*map(float, top2_p[b])) != _printed(*map(float, top2_j[b]))}
    return {ids[b] for b, _, _ in rows} | shown


def _same_but_flips(got: str, want: str, flips: set[str]) -> None:
    """The same reads in the same order, every line equal but the
    flipped reads'."""
    g, w = got.splitlines(), want.splitlines()
    assert [ln.split("\t")[0] for ln in g] == [ln.split("\t")[0] for ln in w]
    diff = {a.split("\t")[0] for a, b in zip(g, w) if a != b}
    assert diff <= flips, sorted(diff - flips)
    assert len(g) > 2 * len(flips)


@pytest.mark.parametrize("engine", ["pallas", "native"])
def test_exact_engines_match_jax(dna, engine):
    """--engine pallas and --engine native: byte-identical to sigfish_tpu
    on the same engine, clipped reads included; the native engine runs
    no kernel and no plain sweep."""
    from sigfish_tpu_torch.ops import sdtw_wavefront as wf

    before = (wf.wavefront_plain.calls, ss.scan_plain.calls)
    got, core = run_port(*dna, engine=engine)
    assert core.engine == engine and got.count("\n") > 20
    if engine == "native":
        assert (wf.wavefront_plain.calls, ss.scan_plain.calls) == before
        assert core.routes["oneshot"] == 0
    assert got == run_jax(*dna, engine)[0]


@pytest.mark.parametrize("accel,engine", [(True, "pallas"), (False, "scan")])
def test_accel_picks_the_jax_engine(dna, accel, engine):
    """--accel yes is the pallas engine and --accel no the scan engine:
    the Core's choice and its PAF are those of --engine; --engine wins
    over --accel."""
    got, core = run_port(*dna, use_pallas=accel)
    assert core.engine == engine and core.use_pallas == accel
    assert got == run_port(*dna, engine=engine)[0]
    assert run_port(*dna, use_pallas=accel, engine="native")[1].engine == "native"


def test_no_flag_keeps_the_wavefront(dna):
    """Neither flag: the wavefront kernel, as before the engine choice."""
    from sigfish_tpu_torch.ops import sdtw_wavefront as wf

    before = ss.scan_plain.calls
    got, core = run_port(*dna)
    assert core.engine == "pallas" and ss.scan_plain.calls == before
    assert wf.wavefront_plain.calls > 0
    assert got == run_port(*dna, engine="pallas")[0]


@pytest.mark.parametrize("kind", ["dna", "rna", "rna_std"])
def test_scan_engine_matches_jax_scan(request, kind):
    """--engine scan against sigfish_tpu's scan engine: R9 DNA with
    clipped reads, direct RNA `--rna -q 500 -p -1` (Q=512) and RNA
    --dtw-std (the std mode and its corners, -p 50): every line equal but
    the near-tie flips _scan_flips finds and checks. The scan ran (its
    plain sweep) and no wavefront."""
    from sigfish_tpu_torch.ops import sdtw_wavefront as wf

    files = request.getfixturevalue("dna" if kind == "dna" else "rna")
    opt = {"dna": {}, "rna": RNA, "rna_std": dict(rna=True, query_size=500, dtw_std=True)}[kind]
    before = (wf.wavefront_plain.calls, ss.scan_plain.calls)
    got, core = run_port(*files, engine="scan", **opt)
    assert wf.wavefront_plain.calls == before[0] and ss.scan_plain.calls > before[1]
    assert core.routes["oneshot"] > 0 and core.routes["chunked"] == 0
    if kind == "dna":
        assert core.routes["clip_pass"] > 0
    want = run_jax(*files, "scan", **opt)[0]
    _same_but_flips(got, want, _scan_flips(*files, **opt))


# -q 64 on the mesh, as the JAX package's mesh tests: a shard is a
# multiple of lcm(ckpt, W) columns, 64,000 at -q 250; -p 200 keeps the
# short reads (240-275 events) clipped
MESH_Q = dict(query_size=64, prefix_size=200)


@pytest.mark.parametrize("mesh,mode", [("2x1", "tracks"), ("1x4", "ring")])
def test_scan_on_the_mesh(dna, mesh, mode):
    """The scan on --mesh: tracks mode (2x1) and ring mode (1x4, 2 tracks
    < 4 shards, the carry column handed on; its clipped reads through
    the single-device scan), each PAF byte-identical to the port's
    single-device scan (the same sums, column by column) and, but the
    near-tie flips, to sigfish_tpu's scan on the same mesh."""
    got, core = run_port(*dna, engine="scan", mesh=mesh, batch_size=64, **MESH_Q)
    assert core.mesh_mode == mode and core.routes["mesh_tracks" if mode == "tracks" else "ring"] > 0
    if mode == "ring":
        assert core.routes["clip_pass"] > 0
    assert got == run_port(*dna, engine="scan", **MESH_Q)[0]
    want = run_jax(*dna, "scan", mesh=mesh, batch_size=64, **MESH_Q)[0]
    _same_but_flips(got, want, _scan_flips(*dna, **MESH_Q))


def test_native_engine_on_a_mesh_runs_the_scan(dna):
    """--engine native with --mesh: the grid runs the scan engine, as the
    JAX Core does."""
    got, core = run_port(*dna, engine="native", mesh="2x1", batch_size=64, **MESH_Q)
    assert core.engine == "native" and not core.use_pallas and core.routes["mesh_tracks"] > 0
    assert got == run_port(*dna, engine="scan", **MESH_Q)[0]


def test_native_engine_std_matches_jax(rna):
    """--dtw-std on the native engine: the exact host corners,
    byte-identical to sigfish_tpu's native engine."""
    opt = dict(rna=True, query_size=500, dtw_std=True)
    got, core = run_port(*rna, engine="native", **opt)
    assert core.routes["oneshot"] == 0 and got.count("\n") > 10
    assert got == run_jax(*rna, "native", **opt)[0]
