"""The port's CUDA kernels on the card, each held bit for bit to its
plain PyTorch version. Every test here carries the `gpu` marker and
skips without a CUDA device. The card's machine has no jax, so run
these without the repository's conftest:

    python -m pytest tests/test_torch_gpu.py -q -m gpu --noconftest
"""

from __future__ import annotations

import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from sigfish_tpu_torch.ops import alu_peak as ap
from sigfish_tpu_torch.ops import layout
from sigfish_tpu_torch.ops import sdtw_scan as ss
from sigfish_tpu_torch.ops import sdtw_wavefront as wf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's CUDA kernels run only on the card")
    return torch.device("cuda")


def _case(seed, W, Q):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(50, 900, size=4)
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in sizes]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=512, align=W)
    qlens = rng.integers(1, W + 1, size=40)
    qlens[::3] = W
    qlist = [rng.standard_normal(int(n)).astype(np.float32) for n in qlens]
    qb, qlens, _ = layout.make_query_batch(qlist, pad_q=Q)
    qb_k, fs = layout.shift_queries_for_clip(qb, qlens, W - 1)
    ypad, rspad, _ = layout.prepare_wavefront_inputs(ref, reset, Q)
    return qb_k, fs, ypad, rspad, W - 1


@pytest.mark.gpu
@pytest.mark.parametrize("W,Q", [(100, 128), (250, 256), (300, 384), (500, 512)])
@pytest.mark.parametrize("std", [False, True])
def test_wavefront_kernel_bitwise_vs_plain(cuda_device, W, Q, std):
    """Every Q the pipeline pads to, clipped reads and std included; the
    launch is counted once."""
    qb, fs, ypad, rspad, lane = _case(W + Q, W, Q)
    q, y, r, sl = (torch.from_numpy(a).to(cuda_device) for a in (qb, ypad, rspad, fs))
    before = wf.sdtw_wavefront.launches
    got = wf.sdtw_wavefront(q, y, r, lane, start_lanes=sl, std=std)
    torch.cuda.synchronize()
    assert wf.sdtw_wavefront.launches == before + 1
    want = wf.wavefront_plain(q, y, r, lane, sl, std)
    assert torch.equal(got.view(torch.int32).cpu(), want.view(torch.int32).cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("W,Q", [(100, 128), (250, 256), (300, 384), (500, 512)])
@pytest.mark.parametrize("std", [False, True])
def test_wavefront_each_warps_bitwise_vs_plain(cuda_device, W, Q, std):
    """Every warps-per-read instance built for Q, clipped reads and std
    included, against one plain run; each launch counted under its warps."""
    qb, fs, ypad, rspad, lane = _case(W + Q + 1, W, Q)
    q, y, r, sl = (torch.from_numpy(a).to(cuda_device) for a in (qb, ypad, rspad, fs))
    want = wf.wavefront_plain(q, y, r, lane, sl, std).view(torch.int32).cpu()
    for w in wf.WARPS:
        if Q % (32 * w):
            continue
        before = wf.sdtw_wavefront.launches_by_warps[w]
        got = wf.sdtw_wavefront(q, y, r, lane, start_lanes=sl, std=std, warps=w)
        torch.cuda.synchronize()
        assert wf.sdtw_wavefront.launches_by_warps[w] == before + 1
        assert torch.equal(got.view(torch.int32).cpu(), want), w


def _carry_chain(dev, clipped, std, warps_of):
    """The carry kernel chained over four uneven segments (37, then 32
    more at a third of D), segment i at warps_of(i) warps per read, each
    launch held to the plain carry chain: scores bitwise, and the state
    bitwise under carry_state_mask (all of it for full-length reads).
    Returns the chained scores and the one-shot launch's, on the host."""
    W, Q = 250, 256
    qb, fs, ypad, rspad, lane = _case(7, W, Q)
    if not clipped:
        qb = np.random.default_rng(8).standard_normal(qb.shape).astype(np.float32)
        fs = None
    q, y, r = (torch.from_numpy(a).to(dev) for a in (qb, ypad, rspad))
    sl = None if fs is None else torch.from_numpy(fs).to(dev)
    B, D = q.shape[0], y.shape[1]
    state = (
        torch.full((B, Q), layout.BIG, device=dev),
        torch.full((B, Q), layout.BIG, device=dev),
        torch.full((1, Q), layout.PAD, device=dev),
        torch.zeros((1, Q), device=dev),
    )
    plain_state = state
    masks = wf.carry_state_mask(sl, B, Q, dev)
    cuts = [0, 37, D // 3, D // 3 + 32, D]
    got = []
    for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        w = warps_of(i)
        before = wf.sdtw_wavefront_carry.launches_by_warps[w]
        out = wf.sdtw_wavefront_carry(q, y[:, lo:hi], r[:, lo:hi], *state, lane, sl, std, warps=w)
        want = wf.wavefront_plain(q, y[:, lo:hi], r[:, lo:hi], lane, sl, std, *plain_state)
        torch.cuda.synchronize()
        assert wf.sdtw_wavefront_carry.launches_by_warps[w] == before + 1
        assert torch.equal(out[0].view(torch.int32).cpu(), want[0].view(torch.int32).cpu()), (i, w)
        for name, g, x, m in zip(("a1", "a2", "ywin", "rswin"), out[1:], want[1:], masks):
            assert torch.equal(g[m].view(torch.int32).cpu(), x[m].view(torch.int32).cpu()), (name, i, w)
        got.append(out[0])
        state, plain_state = out[1:], want[1:]
    one = wf.sdtw_wavefront(q, y, r, lane, start_lanes=sl, std=std)
    return torch.cat(got, 1).view(torch.int32).cpu(), one.view(torch.int32).cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("warps", wf.WARPS)
@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("std", [False, True])
def test_carry_kernel_chained_bitwise_vs_plain(cuda_device, clipped, std, warps):
    """The carry kernel at each warps-per-read instance of Q=256, chained
    over four uneven segments: scores and the masked outgoing state equal
    the plain version's after every segment, and the chained scores equal
    one one-shot launch."""
    chained, one = _carry_chain(cuda_device, clipped, std, lambda i: warps)
    assert torch.equal(chained, one)


@pytest.mark.gpu
@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("std", [False, True])
def test_carry_kernel_chain_mixing_warps(cuda_device, clipped, std):
    """Consecutive launches at 8, 1, 2 and 4 warps per read: the same
    scores and masked state as the plain chain, and as one launch."""
    chained, one = _carry_chain(cuda_device, clipped, std, lambda i: (8, 1, 2, 4)[i])
    assert torch.equal(chained, one)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_clip_fold_on_the_card_vs_cpu(cuda_device, seed):
    """The chunked route's clip fold (ops/chunked_ref.ClipFold) inside a
    carry chain on the card, with the W-window fold beside it and every
    launch counted with start lanes: both folds' packed results equal the
    same chain's on the CPU (plain versions), bit for bit."""
    from sigfish_tpu_torch.ops import chunked_ref as cr

    W, Q = 250, 256
    qb, fs, ypad, rspad, lane = _case(seed + 20, W, Q)
    rng = np.random.default_rng(seed + 30)
    sizes = [int(x) for x in rng.integers(2000, 5000, size=4)]
    sizes[1] = 100  # a contig shorter than most qlens
    tracks = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    ref, reset, offsets = layout.pad_tracks(tracks, ckpt=512, align=W)
    _, valid = layout.build_column_maps(offsets, ref.shape[0], track_sizes=sizes)
    yps, rps, vs, Ds, nwin = cr.prepare_chunked_inputs(ref, reset, valid, Q, W, target=1000)
    ts, ls = cr.prepare_clip_inputs(offsets, sizes, W, vs.shape[0], Ds)
    qlens = np.where(fs > 0, W - fs, W).astype(np.int32)
    rows = np.where(qlens != W)[0]
    bases, n_win = cr.clip_window_bases(sizes, qlens[rows])

    def run(dev):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        clip = cr.ClipFold(t(rows), t(qlens[rows]), t(bases), n_win, t(ts), t(ls), t(vs), W)
        window = cr.WindowFold(qb.shape[0], t(vs), W, nwin)
        cr.carry_chain(t(qb), t(yps), t(rps), lane, [window, clip], t(fs))
        return window.top5().view(torch.int32).cpu(), clip.top5().view(torch.int32).cpu()

    before = wf.sdtw_wavefront_carry.launches_start_lanes
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert wf.sdtw_wavefront_carry.launches_start_lanes == before + vs.shape[0] >= before + 3
    for g, w in zip(got, run("cpu")):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("ref_chunk", [-1, 300])
def test_std_corners_on_the_card_vs_cpu(cuda_device, tmp_path, ref_chunk):
    """--dtw-std's corners on the card, one-shot (ref_chunk=-1: the std
    instance) and chunked (a forced ref_chunk: the std carry instance
    and CornerFold), equal the CPU's bit for bit on a batch with clipped
    reads, and the whole run's PAF is the CPU's."""
    from sigfish_tpu_torch.runtime import pipeline as tp

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    fa, bl, _ = smoke.make_rna_workload(str(tmp_path), 6, 30, 9, tx_len=(300, 600),
                                        walks=(150, 70))
    opt = dict(rna=True, query_size=100, prefix_size=-1, dtw_std=True, ref_chunk=ref_chunk,
               batch_size=16, num_thread=1)
    counter = wf.sdtw_wavefront_carry if ref_chunk > 0 else wf.sdtw_wavefront
    corners, pafs = [], []
    for dev in ("cuda", "cpu"):
        core = tp.Core(fa, bl, tp.Options(device=dev, **opt))
        works = [tp._prepare_read(core, b) for b in core.sf.read_batch(30, 1 << 40)]
        qb, qlens, _ = tp.make_query_batch([w.query for w in works if not w.skip],
                                           pad_q=core.pad_q)
        assert (qlens < 100).sum() >= 2
        before = counter.launches_std
        corners.append(core.sdtw_std_corners_collect(core.sdtw_std_corners_submit(qb, qlens)))
        if dev == "cuda":
            assert counter.launches_std > before
        core.close()
        core = tp.Core(fa, bl, tp.Options(device=dev, **opt))
        out = io.StringIO()
        tp.run_dtw(core, out)
        core.close()
        pafs.append(out.getvalue())
    assert np.array_equal(corners[0].view(np.int32), corners[1].view(np.int32))
    assert pafs[0] == pafs[1] != ""


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ap.MODES)
def test_alu_peak_kernel_bitwise_vs_plain(cuda_device, mode):
    x = torch.from_numpy(np.random.default_rng(3).random((40, ap.Q), np.float32)).to(cuda_device)
    before = ap.alu_peak.launches
    got = ap.alu_peak(x, mode, 24)
    torch.cuda.synchronize()
    assert ap.alu_peak.launches == before + 1
    want = ap.alu_peak_plain(x, mode, 24)
    assert torch.equal(got.view(torch.int32).cpu(), want.view(torch.int32).cpu())


def _scan_case(seed, W, Q, B=40):
    """(queries, one-hot, ref, reset) of the scan: four random tracks and
    B reads, full-length, clipped and one of qlen 0."""
    rng = np.random.default_rng(seed)
    tracks = [rng.standard_normal(int(s)).astype(np.float32) for s in rng.integers(50, 900, 4)]
    ref, reset, _ = layout.pad_tracks(tracks, ckpt=512, align=W)
    qlens = rng.integers(1, W + 1, size=B)
    qlens[::3], qlens[-1] = W, 0
    qb, _, oh = layout.make_query_batch(
        [rng.standard_normal(int(n)).astype(np.float32) for n in qlens], pad_q=Q)
    return qb, oh, ref, reset


@pytest.mark.gpu
@pytest.mark.parametrize("W,Q", [(100, 128), (250, 256), (300, 384), (500, 512)])
@pytest.mark.parametrize("std", [False, True])
def test_scan_kernel_bitwise_vs_plain(cuda_device, W, Q, std):
    """Every Q the pipeline pads to, std included: the one-shot launch
    (counted once) and its final column, and a chain of three uneven
    segments through the carry, bitwise against the plain version."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _scan_case(W + Q, W, Q)]
    before = ss.sdtw_scan.launches
    got = ss.sdtw_scan(*args, std=std)
    torch.cuda.synchronize()
    assert ss.sdtw_scan.launches == before + 1
    want = ss.scan_plain(*args, std=std)
    assert _same_bytes(got[0], want[0]) and _same_bytes(got[1], want[1])
    q, oh, y, r = args
    init, parts = None, []
    for a, b in ((0, 333), (333, 1024), (1024, y.shape[0])):
        lr, init = ss.sdtw_scan(q, oh, y[a:b], r[a:b], std=std, init=init)
        parts.append(lr)
    assert _same_bytes(torch.cat(parts, 1), want[0]) and _same_bytes(init, want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dna", "rna_std"])
def test_scan_engine_on_the_card_vs_cpu(cuda_device, tmp_path, kind):
    """run_dtw with --engine scan on the card: the scan kernel launched,
    no wavefront and no plain sweep, and the PAF byte for byte the CPU
    run's (R9 DNA with clipped reads; RNA --dtw-std, the std mode)."""
    from sigfish_tpu_torch.runtime import pipeline as tp

    smoke = _load_smoke()
    if kind == "dna":
        fa, bl = smoke.make_workload(str(tmp_path), 3000, 96, 13)[:2]
        opt = dict(batch_size=64)
    else:
        fa, bl = smoke.make_rna_workload(str(tmp_path), 6, 48, 17, tx_len=(600, 1500))[:2]
        opt = dict(rna=True, query_size=500, dtw_std=True, batch_size=32)
    pafs = []
    for device in ("cuda", "cpu"):
        before = (ss.sdtw_scan.launches, ss.scan_plain.calls, wf.sdtw_wavefront.launches)
        core = tp.Core(fa, bl, tp.Options(device=device, engine="scan", num_thread=2, **opt))
        out = io.StringIO()
        tp.run_dtw(core, out)
        core.close()
        pafs.append(out.getvalue())
        if device == "cuda":
            assert ss.sdtw_scan.launches > before[0]
            assert (ss.scan_plain.calls, wf.sdtw_wavefront.launches) == before[1:]
    assert pafs[0] == pafs[1] != ""


@pytest.mark.gpu
def test_scan_kernel_refuses_unbuilt_width(cuda_device):
    """A Q the kernel is not built for raises; nothing launches."""
    args = [torch.from_numpy(a).to(cuda_device) for a in _scan_case(1, 150, 160)]
    before = ss.sdtw_scan.launches
    with pytest.raises(ValueError):
        ss.sdtw_scan(*args)
    assert ss.sdtw_scan.launches == before


@pytest.mark.gpu
def test_wavefront_kernel_refuses_unbuilt_width(cuda_device):
    """A CUDA tensor never falls back to the plain version."""
    q = torch.zeros((4, 96), device=cuda_device)
    y = torch.zeros((1, 512), device=cuda_device)
    with pytest.raises(ValueError, match="kernel takes"):
        wf.sdtw_wavefront(q, y, y.clone(), 50)


def _load_smoke():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _same_bytes(a, b) -> bool:
    a, b = a.contiguous().cpu(), b.contiguous().cpu()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("rna", [False, True])
def test_events_kernel_bitwise_vs_plain(cuda_device, rna):
    """csrc/events.cu against detect_peaks_plain on the card: the prefix
    planes, peaks, counts, overflow flags and gathered sums, bit for bit,
    on the fuzz mix with an overflowing read; the launch is counted once."""
    from sigfish_tpu_torch.ops import events_device as ev

    args = ev.batch_tensors(*_load_smoke().host_stage_batch(5 + rna, rna, S=4096), cuda_device)
    E = ev.event_cap(4096)
    before = ev.detect_peaks.launches
    got = ev.detect_peaks(*args, rna, E)
    torch.cuda.synchronize()
    assert ev.detect_peaks.launches == before + 1
    want = ev.detect_peaks_plain(*args, rna, E)
    for name, g, w in zip(ev.Peaks._fields, got, want):
        assert _same_bytes(g, w), name
    assert bool(got.overflow.any()) == (not rna)


def _event_batch(smoke, kind, rna):
    """fuzz: the 64-read fuzz batch at S=4,096; edges: the ragged batch
    (B=37, which the wrappers pad to 40 lanes); edges32: its first 32 rows
    (one warp, no padding)."""
    if kind == "fuzz":
        return smoke.host_stage_batch(5 + rna, rna, S=4096)
    b = smoke.edge_event_batch(3, rna)
    return tuple(a[:32] for a in b) if kind == "edges32" else b


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fuzz", "edges", "edges32"])
@pytest.mark.parametrize("rna", [False, True])
def test_events_stages_bitwise_vs_plain(cuda_device, rna, kind):
    """Each stage of csrc/events.cu alone, on the same card tensors as its
    plain stage: the prefix planes and A, Q at n against prefix_sums_plain,
    t1 and t2 against tstat_plain, peaks, counts and overflow against
    detector_plain, the gathered sums against _gather; then the whole
    call, counted once, against all of them."""
    _events_stages_check(cuda_device, rna, kind)


def _events_stages_check(dev, rna, kind):
    from sigfish_tpu_torch.ops import events_device as ev

    args = ev.batch_tensors(*_event_batch(_load_smoke(), kind, rna), dev)
    sig, ns, ru, of = args
    E = ev.event_cap(sig.shape[0])
    prm = ev.RNA_PARAMS if rna else ev.DNA_PARAMS
    A, Q = ev.prefix_sums_plain(ev.pa_plain(sig, ru, of), ns)
    t1 = ev.tstat_plain(A, Q, ns, prm["window_length1"])
    t2 = ev.tstat_plain(A, Q, ns, prm["window_length2"])
    pk, cn, ov = ev.detector_plain(t1, t2, ns, prm, E)
    ps, pq, es, eq = ev._gather(A, Q, pk, ns)
    stages = [
        (ev.prefix_stage(*args), (A, Q, es, eq)),
        (ev.tstat_stage(A, Q, ns, rna), (t1, t2)),
        (ev.detector_stage(t1, t2, ns, rna, E), (pk, cn, ov)),
        (ev.gather_stage(A, Q, pk, cn, ns), (ps, pq)),
    ]
    for i, (got, want) in enumerate(stages):
        for j, (g, w) in enumerate(zip(got, want)):
            assert _same_bytes(g, w), (i, j)
    before = ev.detect_peaks.launches
    got = ev.detect_peaks(*args, rna, E)
    torch.cuda.synchronize(dev)
    assert ev.detect_peaks.launches == before + 1
    for name, g, w in zip(ev.Peaks._fields, got, (A, Q, pk, cn, ov, ps, pq, es, eq)):
        assert _same_bytes(g, w), name
    assert bool(ov.any()) == (not rna)


@pytest.mark.gpu
def test_events_kernel_empty_signal(cuda_device):
    """A batch of S = 0 samples (B = 12, padded to 16 lanes): every
    count, overflow flag, peak slot and sum is written, 0, and A and Q
    are their one row of zeros. The plain version needs S > 2 * w2."""
    from sigfish_tpu_torch.ops import events_device as ev

    B = 12
    got = ev.detect_peaks(torch.zeros((0, B), dtype=torch.int16, device=cuda_device),
                          torch.zeros(B, dtype=torch.int32, device=cuda_device),
                          torch.ones(B, device=cuda_device), torch.zeros(B, device=cuda_device),
                          False, ev.event_cap(0))
    torch.cuda.synchronize()
    shapes = dict(A=(1, B), Q=(1, B), peaks=(B, 64), counts=(B,), overflow=(B,), psum=(B, 64),
                  psumsq=(B, 64), end_sum=(B,), end_sumsq=(B,))
    for name, g in zip(ev.Peaks._fields, got):
        assert tuple(g.shape) == shapes[name] and not g.any(), name


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [37, 32])
@pytest.mark.parametrize("pore", [0, 2])
def test_polya_kernel_edges_bitwise_vs_plain(cuda_device, pore, rows):
    """csrc/polya.cu against polya_end_plain on the ragged polyA batch:
    reads no longer than the window, without adaptor, with the shortest
    tails, of S = 8,292 samples; B=37 (padded to 40 lanes) and its first
    32 rows; counted once a call."""
    from sigfish_tpu_torch.ops import events_device as ev
    from sigfish_tpu_torch.ops import jnn_device as jd

    b = tuple(a[:rows] for a in _load_smoke().edge_polya_batch(4))
    args = ev.batch_tensors(*b, cuda_device)
    before = jd.polya_end.launches
    got = jd.polya_end(*args, pore)
    torch.cuda.synchronize()
    assert jd.polya_end.launches == before + 1
    assert torch.equal(got.cpu(), jd.polya_end_plain(*args, pore).cpu())
    assert bool((got[:7] < 0).all()) and int((got >= 0).sum()) >= 10


@pytest.mark.gpu
@pytest.mark.parametrize("pore", [0, 2])
def test_polya_kernel_bitwise_vs_plain(cuda_device, pore):
    """csrc/polya.cu against polya_end_plain on the card (R9 and RNA004
    parameters), polyA-shaped, noise, short and empty reads."""
    from sigfish_tpu_torch.ops import events_device as ev
    from sigfish_tpu_torch.ops import jnn_device as jd

    args = ev.batch_tensors(*_load_smoke().host_stage_batch(7, True), cuda_device)
    before = jd.polya_end.launches
    got = jd.polya_end(*args, pore)
    torch.cuda.synchronize()
    assert jd.polya_end.launches == before + 1
    want = jd.polya_end_plain(*args, pore)
    assert torch.equal(got.cpu(), want.cpu())
    assert int((got >= 0).sum()) >= 10 and int((got < 0).sum()) >= 3


@pytest.mark.gpu
def test_host_stages_device_on_the_card(cuda_device, tmp_path):
    """--host-stages device on the card: the PAF equals the host mode's,
    and both kernels ran on the Core's own stream."""
    from sigfish_tpu_torch.ops import events_device as ev
    from sigfish_tpu_torch.ops import jnn_device as jd
    from sigfish_tpu_torch.runtime import pipeline as tp

    smoke = _load_smoke()
    fa, bl, _ = smoke.make_rna_workload(str(tmp_path), 6, 24, 9, tx_len=(600, 1400))
    opt = dict(rna=True, query_size=500, prefix_size=-1, batch_size=16, num_thread=2)
    pafs = []
    for hs in ("host", "device"):
        before = (ev.detect_peaks.launches, jd.polya_end.launches)
        core = tp.Core(fa, bl, tp.Options(device="cuda", host_stages=hs, **opt))
        out = io.StringIO()
        tp.run_dtw(core, out)
        core.close()
        pafs.append(out.getvalue())
        ran = (ev.detect_peaks.launches > before[0], jd.polya_end.launches > before[1])
        assert ran == ((True, True) if hs == "device" else (False, False))
        assert (core.host_stream is not None) == (hs == "device")
    assert pafs[0] == pafs[1] != ""


def _mesh_run(smoke, tmp_path, mesh, n_dev, device, engine=None):
    """(packed candidates of one batch, PAF) of a --mesh run over a
    one-contig DNA workload (-p 210 -q 64 clips its short reads) on
    n_dev "cuda:0" entries or on the CPU, on the engine given."""
    from sigfish_tpu_torch.runtime import pipeline as tp

    d = tmp_path / "w"
    if not d.exists():
        d.mkdir()
        smoke.make_workload(str(d), 900, 40, 41)
    fa, bl = str(d / "ref.fa"), str(d / "reads.blow5")
    opt = dict(query_size=64, prefix_size=210, ckpt=64, batch_size=64, num_thread=2, mesh=mesh,
               mesh_devices=[device] * n_dev, device=device.split(":")[0], engine=engine)
    core = tp.Core(fa, bl, tp.Options(**opt))
    works = [tp._prepare_read(core, b) for b in core.sf.read_batch(64, 1 << 40)]
    qb, qlens, _ = tp.make_query_batch([w.query for w in works if not w.skip], pad_q=core.pad_q)
    assert (qlens < 64).sum() >= 2
    ts, tp_ = core.sdtw_candidates_collect(core.sdtw_candidates_submit(qb, qlens))
    core.close()
    core = tp.Core(fa, bl, tp.Options(**opt))
    out = io.StringIO()
    tp.run_dtw(core, out)
    core.close()
    return ts.view(np.int32), tp_, out.getvalue(), core


@pytest.mark.gpu
@pytest.mark.parametrize("mesh,n_dev,mode", [("2x2", 4, "tracks"), ("1x4", 4, "ring")])
def test_mesh_on_the_card_vs_cpu(cuda_device, tmp_path, mesh, n_dev, mode):
    """A tracks mesh and a ring mesh over one card listed n times (a
    stream per shard): the batch's top-5 scores and positions bitwise and
    the PAF byte for byte the CPU's; no plain sweep ran on the card."""
    smoke = _load_smoke()
    plain = wf.wavefront_plain.calls
    ts, tp_, paf, core = _mesh_run(smoke, tmp_path, mesh, n_dev, "cuda:0")
    assert wf.wavefront_plain.calls == plain
    assert core.mesh_mode == mode and core.device == torch.device("cuda", 0)
    want = _mesh_run(smoke, tmp_path, mesh, n_dev, "cpu")
    assert np.array_equal(ts, want[0]) and np.array_equal(tp_, want[1])
    assert paf == want[2] != ""


@pytest.mark.gpu
@pytest.mark.parametrize("mesh,n_dev,mode", [("2x2", 4, "tracks"), ("1x4", 4, "ring")])
def test_scan_mesh_on_the_card_vs_cpu(cuda_device, tmp_path, mesh, n_dev, mode):
    """The scan engine on a tracks mesh and a ring mesh over one card
    listed n times: the batch's top-5 and the PAF the CPU's, bit for bit;
    the scan kernel ran and no plain sweep and no wavefront."""
    smoke = _load_smoke()
    before = (ss.scan_plain.calls, ss.sdtw_scan.launches, wf.sdtw_wavefront.launches,
              wf.sdtw_wavefront_carry.launches)
    ts, tp_, paf, core = _mesh_run(smoke, tmp_path, mesh, n_dev, "cuda:0", "scan")
    assert ss.sdtw_scan.launches > before[1]
    assert (ss.scan_plain.calls, wf.sdtw_wavefront.launches,
            wf.sdtw_wavefront_carry.launches) == (before[0], *before[2:])
    assert core.mesh_mode == mode
    want = _mesh_run(smoke, tmp_path, mesh, n_dev, "cpu", "scan")
    assert np.array_equal(ts, want[0]) and np.array_equal(tp_, want[1])
    assert paf == want[2] != ""


@pytest.mark.gpu
def test_kernels_on_a_second_card(cuda_device):
    """Each wrapper launches on its tensor's card with the current device
    left at 0 (a stream and shared-memory attribute of cuda:1, not of
    cuda:0), bitwise against its plain version. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from sigfish_tpu_torch.ops import events_device as ev
    from sigfish_tpu_torch.ops import jnn_device as jd

    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    qb, fs, ypad, rspad, lane = _case(5, 100, 128)
    q, y, r, sl = (torch.from_numpy(a).to(dev) for a in (qb, ypad, rspad, fs))
    got = wf.sdtw_wavefront(q, y, r, lane, start_lanes=sl)
    assert _same_bytes(got, wf.wavefront_plain(q, y, r, lane, sl))
    state = wf.carry_fresh_state(q.shape[0], q.shape[1], dev)
    got = wf.sdtw_wavefront_carry(q, y, r, *state, lane, start_lanes=sl)
    assert _same_bytes(got[0], wf.wavefront_plain(q, y, r, lane, sl, False, *state)[0])
    x = torch.from_numpy(np.random.default_rng(3).random((40, ap.Q), np.float32)).to(dev)
    assert _same_bytes(ap.alu_peak(x, "mix", 24), ap.alu_peak_plain(x, "mix", 24))
    _events_stages_check(dev, True, "fuzz")  # the four stages, then detect_peaks
    args = ev.batch_tensors(*_load_smoke().host_stage_batch(7, True), dev)
    assert _same_bytes(jd.polya_end(*args, 0), jd.polya_end_plain(*args, 0))
    sargs = [torch.from_numpy(a).to(dev) for a in _scan_case(5, 100, 128)]
    assert _same_bytes(ss.sdtw_scan(*sargs)[0], ss.scan_plain(*sargs)[0])
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0


@pytest.mark.gpu
def test_hosts_on_the_card_vs_cpu(cuda_device, tmp_path):
    """A 2-host cluster of CLI processes sharing the card, each tracing
    its run: host 0's PAF is the CPU run's byte for byte, the peer opens
    no -o, and each host's Chrome trace holds the wavefront kernel's
    events, one for each of its launches (its -v 5 count)."""
    import json
    import socket
    import subprocess
    import sys

    from sigfish_tpu_torch import cli

    smoke = _load_smoke()
    fa, bl, _ = smoke.make_workload(str(tmp_path), 900, 40, 43)
    out = tmp_path / "cpu.paf"
    assert cli.main(["dtw", fa, bl, "--device", "cpu", "-K", "8", "-o", str(out)]) == 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trace = tmp_path / "trace"
    outs = [tmp_path / f"h{i}.paf" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "sigfish_tpu_torch.cli", "dtw", fa, bl, "-K", "8", "-v", "5",
         "--hosts", "2", "--host-id", str(i), "--coordinator", f"localhost:{port}",
         "--trace", str(trace), "-o", str(outs[i])],
        cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], errs
    assert outs[0].read_text() == out.read_text() != "" and not outs[1].exists()
    for i, err in enumerate(errs):
        line = next(ln for ln in err.splitlines() if "kernel launches:" in ln)
        launches = int(line.split("sdtw_wavefront=")[1].split()[0])
        with open(cli.trace_path(str(trace), i)) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and "wavefront_kernel" in e.get("name", "")]
        assert len(kernels) == launches > 0, (i, len(kernels), launches)


def _train_batch(seed, rows, cols, clip, ints=False):
    """Ragged f32 rows and columns from a seed: normals (the columns
    clipped), or with ints values from {0, 1, 2}, on which the DPs' moves
    and end candidates tie often."""
    rng = np.random.default_rng(seed)
    if ints:
        return ([rng.integers(0, 3, n).astype(np.float32) for n in rows],
                [rng.integers(0, 3, m).astype(np.float32) for m in cols])
    return ([rng.standard_normal(n).astype(np.float32) for n in rows],
            [np.clip(rng.standard_normal(m), -clip, clip).astype(np.float32) for m in cols])


# (rows, columns, ints) of each gap batch: ragged with empty, one-row and
# one-column cases and rows past one stripe; tie-heavy; cases longer than
# a warp's registers hold (several 256-row stripes); B=1; B=37, a multiple
# of no per-block case count; every case shorter than one lane's 8 rows or
# than the lanes' 32 runs (the stripe starts above row 0)
GAP_BATCHES = {
    "ragged": ([700, 0, 1, 37, 300, 5, 256], [900, 12, 40, 0, 280, 1, 257], False),
    "ties": ([700, 1, 37, 300, 64, 65], [900, 40, 33, 280, 64, 2], True),
    "long": ([2_500, 2_500, 700], [3_000, 1_200, 3_000], False),
    "one": ([689], [906], False),
    "odd": (list(range(5, 5 + 37 * 19, 19)), list(range(900, 900 - 37 * 23, -23)), True),
    "short": ([1, 5, 8, 32, 31, 200], [40, 3, 17, 60, 1, 90], True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("batch", list(GAP_BATCHES))
@pytest.mark.parametrize("gaps", [(0.8, 0.3), (0.6, 0.2), (0.5, 0.25)])
def test_gap_dtw_kernel_bitwise_vs_plain(cuda_device, gaps, batch):
    """csrc/gap_dtw.cu against gap_sdtw_plain on the card over each of
    GAP_BATCHES: end, end cost and the whole padded path buffers equal,
    the launch counted once."""
    from sigfish_tpu_torch.ops import train_dtw as td

    rows_n, cols_m, ints = GAP_BATCHES[batch]
    rows, cols = _train_batch(11, rows_n, cols_m, 3.5, ints)
    x, n = td.pack(rows, cuda_device)
    y, m = td.pack(cols, cuda_device)
    before = td.gap_sdtw.launches
    got = td.gap_sdtw(x, y, n, m, *gaps)
    torch.cuda.synchronize()
    assert td.gap_sdtw.launches == before + 1
    want = td.gap_sdtw_plain(x, y, n, m, *gaps)
    assert all(_same_bytes(a, b) for a, b in zip(got, want))
    assert int(got[4].max()) >= max(rows_n)


@pytest.mark.gpu
def test_gap_dtw_kernel_flags_lengths_past_the_padding(cuda_device):
    """The gap wrapper leaves the lengths on the card: a case whose n or
    m lies outside the padding gets end -1, end cost NaN and no path from
    the kernel, the other cases their plain results."""
    from sigfish_tpu_torch.ops import train_dtw as td

    rows, cols = _train_batch(14, [40, 30, 20, 25], [50, 35, 10, 28], 3.5)
    x, n = td.pack(rows, cuda_device)
    y, m = td.pack(cols, cuda_device)
    bad_n, bad_m = n.clone(), m.clone()
    bad_n[1], bad_m[2] = x.shape[1] + 1, -1
    end, end_cost, px, py, plen = got = td.gap_sdtw(x, y, bad_n, bad_m, 0.5, 0.25)
    want = td.gap_sdtw_plain(x, y, n, m, 0.5, 0.25)
    for b in (1, 2):
        assert int(end[b]) == -1 and bool(torch.isnan(end_cost[b])) and int(plen[b]) == 0
        assert bool((px[b] == -1).all()) and bool((py[b] == -1).all())
    keep = torch.tensor([0, 3], device=cuda_device)
    assert all(_same_bytes(a[keep], b[keep]) for a, b in zip(got, want))


def _banded_batch(kind, slack):
    """(ns, ms, bands, ints) of a banded batch: 130 ragged cases with
    empty ones, n below, equal to and above m, bands narrower and wider
    than the matrix; the same tie-heavy; one case 2,000 x 2,000 with band
    200 beside shorter ones; rows whose bands do not overlap (m / n past
    2 * (end_slack + 8) + 1) and tall cases (n >= 4m); B=1; B=37."""
    rng = np.random.default_rng(slack)
    if kind in ("ragged", "ties"):
        ns = rng.integers(1, 400, 130)
        ms = np.where(rng.random(130) < 0.5, ns, rng.integers(1, 400, 130))
        ns[3], ms[9] = 0, 0
        ns[0] = ms[0] = 760
        bands = ns // 10
        bands[5] = 1_000
        return ns, ms, bands, kind == "ties"
    if kind == "long":
        return (np.array([2_000, 1_500, 40]), np.array([2_000, 2_100, 90]),
                np.array([200, 20, 1]), False)
    if kind == "nonoverlap":
        ns = np.array([5, 9, 12, 3, 2_000, 1_200, 800])
        ms = np.array([5 * 150, 9 * 140, 12 * 130, 3 * 400, 400, 300, 150])
        return ns, ms, np.array([1, 2, 1, 2, 2, 1, 2]), True
    if kind == "one":
        return np.array([806]), np.array([806]), np.array([80]), False
    ns = rng.integers(1, 900, 37)
    return ns, rng.integers(1, 900, 37), ns // 10, True


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ragged", "ties", "long", "nonoverlap", "one", "odd"])
@pytest.mark.parametrize("slack", [60, 7])
def test_banded_dtw_kernel_bitwise_vs_plain(cuda_device, slack, kind):
    """csrc/banded_dtw.cu against banded_dtw_plain on the card over each
    of _banded_batch's batches: end cells and the whole padded path
    buffers equal, the launch counted once."""
    from sigfish_tpu_torch.ops import train_dtw as td

    ns, ms, bands, ints = _banded_batch(kind, slack)
    evs, lvls = _train_batch(slack + 1, ns, ms, 4.0, ints)
    ev, n = td.pack(evs, cuda_device)
    lvl, m = td.pack(lvls, cuda_device)
    band = torch.from_numpy(bands.astype(np.int32)).to(cuda_device)
    before = td.banded_dtw.launches
    got = td.banded_dtw(ev, lvl, n, m, band, slack)
    torch.cuda.synchronize()
    assert td.banded_dtw.launches == before + 1
    want = td.banded_dtw_plain(ev, lvl, n, m, band, slack)
    assert all(_same_bytes(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_train_dtw_kernels_with_scratch_buffers(cuda_device, monkeypatch):
    """Both kernels with their per-case buffers in a device scratch (the
    path a case too wide for shared memory takes), forced by setting the
    limit to nothing: bitwise against the plain versions."""
    from sigfish_tpu_torch.ops import train_dtw as td

    monkeypatch.setattr(td, "SMEM_CASE_BYTES", 0)
    rows, cols = _train_batch(12, [700, 0, 37, 300, 64], [900, 12, 33, 280, 64], 3.5, ints=True)
    x, n = td.pack(rows, cuda_device)
    y, m = td.pack(cols, cuda_device)
    assert all(_same_bytes(a, b) for a, b in zip(td.gap_sdtw(x, y, n, m, 0.5, 0.25),
                                                  td.gap_sdtw_plain(x, y, n, m, 0.5, 0.25)))
    band = torch.tensor([70, 1, 4, 30, 200], dtype=torch.int32, device=cuda_device)
    assert all(_same_bytes(a, b) for a, b in zip(td.banded_dtw(x, y, n, m, band, 60),
                                                  td.banded_dtw_plain(x, y, n, m, band, 60)))


@pytest.mark.gpu
def test_train_dtw_peak_memory_below_a_matrix(cuda_device):
    """Neither kernel's call holds a (B, N, M) matrix: each call's peak
    device memory above what was allocated before it stays below B*N*M
    bytes (a quarter of one f32 matrix), at phase 12's shapes."""
    from sigfish_tpu_torch.ops import train_dtw as td

    rows, cols = _train_batch(5, [689] * 256, [906] * 256, 3.5)
    x, n = td.pack(rows, cuda_device)
    y, m = td.pack(cols, cuda_device)
    evs, lvls = _train_batch(6, [806] * 512, [806] * 512, 4.0)
    ev, nb = td.pack(evs, cuda_device)
    lvl, mb = td.pack(lvls, cuda_device)
    band = torch.full((512,), 80, dtype=torch.int32, device=cuda_device)
    for fn, cells in ((lambda: td.gap_sdtw(x, y, n, m, 0.5, 0.15), 256 * 689 * 906),
                      (lambda: td.banded_dtw(ev, lvl, nb, mb, band, 60), 512 * 806 * 806)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < cells
        del out


@pytest.mark.gpu
def test_trainer_on_the_card_vs_cpu(cuda_device, tmp_path):
    """fit_model (with its diagnostic), fit_model_banded and
    finetune_inference_matched on the card give the CPU run's tables bit
    for bit, each E-step through its kernel."""
    from sigfish_tpu_torch.io.fasta import read_fasta
    from sigfish_tpu_torch.models import train_model as tm
    from sigfish_tpu_torch.ops import train_dtw as td

    smoke = _load_smoke()
    fa, bl, truth = smoke.make_workload(str(tmp_path), 3_000, 10, 13)
    paf = str(tmp_path / "dna.paf")
    smoke.write_truth_paf(paf, truth, {smoke.contig_of(truth): 3_000})
    tables = {}
    for dev in ("cuda", "cpu"):
        tables[dev] = tm.fit_model(tm.load_cases(bl, fa, paf, rna=False, k=6), k=6, iters=3,
                                   verbose=True, device=dev).level_mean
    assert np.array_equal(tables["cuda"], tables["cpu"])
    rdir = tmp_path / "rna"
    rdir.mkdir()
    fa, bl, truth = smoke.make_rna_workload(str(rdir), 3, 6, 13, tx_len=(250, 450),
                                            walks=(200, 100))
    paf = str(rdir / "rna.paf")
    smoke.write_truth_paf(paf, truth, {name: len(s) for name, s in read_fasta(fa)})
    launches = (td.banded_dtw.launches, wf.sdtw_wavefront.launches)
    for dev in ("cuda", "cpu"):
        cases = tm.load_cases_trimmed_rna(bl, fa, paf, k=5)
        lv = tm.fit_model_banded(cases, k=5, iters=3, verbose=False, device=dev)
        tables[dev] = tm.finetune_inference_matched(lv, tm.inference_windows(cases, fa), k=5,
                                                    iters=2, verbose=False, device=dev)
        if dev == "cuda":
            assert (td.banded_dtw.launches - launches[0], wf.sdtw_wavefront.launches
                    - launches[1]) == (2, 2)
    assert np.array_equal(tables["cuda"], tables["cpu"])
