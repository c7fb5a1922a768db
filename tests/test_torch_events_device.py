"""The port's batched eventizer (`--host-stages device`,
sigfish_tpu_torch/ops/events_device.py) on the CPU, where detect_peaks
runs its plain PyTorch stages: against sigfish_tpu.ops.events_device on
the CPU backend (peaks, counts, overflow flags and the gathered sums, bit
for bit) and against the host eventizer ops/events.detect_events (every
event table, bit for bit); the JAX package's long-read bucketing; and
whole DNA runs with --host-stages device (R9 `-p 50 -q 250`, R10,
--from-end, --profile-cpu) byte-identical to sigfish_tpu's device mode
and to the port's host mode.

Inputs: chip_smoke.py's fuzz mix (stepwise, pure noise, near-flat, very
short), a read whose events overflow the cap, a noiseless stepped read
(subnormal variance quotients), reads shorter than 2 * w2, from a numpy
seed; and chip_smoke.edge_event_batch, the card kernel's ragged edges
(reads of 0, 1, 2 samples, around 2 * w2 and the ring tiles, of S
samples, S = 1,000 a multiple of neither tile, B = 37). S stays at a few
thousand samples, as the plain detector is a Python loop over steps. The
*_stage functions, on the CPU, are the plain stages one by one.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_runs import load_smoke, run_jax, run_port
from sigfish_tpu.ops import events_device as j_ev
from sigfish_tpu_torch import cli
from sigfish_tpu_torch.io.blow5 import Slow5Record
from sigfish_tpu_torch.ops import events as t_host
from sigfish_tpu_torch.ops import events_device as ev
from sigfish_tpu_torch.runtime import pipeline as tp

DIGI, OFF, RANGE = 8192.0, 5.0, 1400.0


def _batch(sigs):
    B = len(sigs)
    S = max(s.size for s in sigs)
    sig = np.zeros((B, S), np.int16)
    ns = np.zeros(B, np.int32)
    for b, s in enumerate(sigs):
        sig[b, : s.size] = s
        ns[b] = s.size
    return sig, ns, np.full(B, DIGI), np.full(B, OFF), np.full(B, RANGE)


def _reads(rna: bool):
    """The fuzz mix plus the corners: a read stepping every 3 samples (its
    DNA events overflow the cap), a noiseless stepped read, and reads of
    10 and 2 * w2 - 1 samples."""
    rng = np.random.default_rng(40 + rna)
    sigs = load_smoke().fuzz_reads(rng, 20, rna)
    steps3 = np.repeat(rng.integers(-20000, 20000, 1400), 3)
    w2 = (t_host.RNA_PARAMS if rna else t_host.DNA_PARAMS)["window_length2"]
    sigs += [
        (steps3 + rng.integers(-3, 4, steps3.size)).astype(np.int16),
        np.repeat(rng.integers(300, 900, 60), 20).astype(np.int16),
        rng.integers(300, 900, 10).astype(np.int16),
        rng.integers(300, 900, 2 * w2 - 1).astype(np.int16),
    ]
    return sigs


@pytest.fixture(scope="module", params=[(False, "fuzz"), (True, "fuzz"), (False, "edges"),
                                        (True, "edges")],
                ids=["dna", "rna", "dna-edges", "rna-edges"])
def case(request):
    """(rna, reads, numpy batch, E, the plain run's Peaks, the noiseless
    stepped read's row) for one parameter set, computed once."""
    rna, kind = request.param
    if kind == "fuzz":
        sigs = _reads(rna)
        batch = _batch(sigs)
        stepped = len(sigs) - 3
    else:
        batch = load_smoke().edge_event_batch(3, rna)
        sigs = [row[:n] for row, n in zip(batch[0], batch[1])]
        stepped = 19
    E = ev.event_cap(batch[0].shape[1])
    res = ev.detect_peaks(*ev.batch_tensors(*batch, "cpu"), rna, E)
    return rna, sigs, batch, E, res, stepped


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def test_plain_stages_bitwise_vs_jax(case):
    """Peaks, counts, overflow and the gathered sums of the plain stages
    equal _detect_events_jit's on the CPU backend, bit for bit (x64 is
    scoped to the call and restored after it)."""
    rna, _, (sig, ns, digi, off, rng_pa), E, res, _ = case
    params = t_host.RNA_PARAMS if rna else t_host.DNA_PARAMS
    x64 = jax.config.jax_enable_x64
    with jax.enable_x64(True):
        want = j_ev._detect_events_jit(
            jnp.asarray(np.ascontiguousarray(sig.T)), jnp.asarray(ns),
            jnp.asarray(rng_pa.astype(np.float32) / digi.astype(np.float32)),
            jnp.asarray(off.astype(np.float32)), jnp.float32(params["window_length1"]),
            jnp.float32(params["window_length2"]), rna=rna, E=E,
        )
        want = [np.asarray(w) for w in want]
    assert jax.config.jax_enable_x64 == x64
    got = [res.peaks, res.counts, res.overflow, res.psum, res.psumsq, res.end_sum, res.end_sumsq]
    for name, g, w in zip(("peaks", "counts", "overflow", "psum", "psumsq", "end_sum",
                           "end_sumsq"), got, want):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name
    assert bool(res.overflow.any()) == (not rna)


def test_plain_prefix_and_tstat_stages_vs_host(case):
    """Each read's prefix sums and both t-stats equal the host's
    compute_prefix_sums and compute_tstat bit for bit, and the noiseless
    stepped read reaches the subnormal quotient: huge t-stats, none
    infinite."""
    rna, sigs, (sig, ns, digi, off, rng_pa), _, res, stepped_row = case
    params = t_host.RNA_PARAMS if rna else t_host.DNA_PARAMS
    args = ev.batch_tensors(sig, ns, digi, off, rng_pa, "cpu")
    ts = [ev.tstat_plain(res.A, res.Q, args[1], params[k])
          for k in ("window_length1", "window_length2")]
    unit = np.float32(RANGE) / np.float32(DIGI)
    for b, s in enumerate(sigs):
        pa = (s.astype(np.float32) + np.float32(off[b])) * unit
        sums, sumsqs = t_host.compute_prefix_sums(pa)
        assert np.array_equal(res.A[: s.size + 1, b].numpy(), sums), b
        assert np.array_equal(res.Q[: s.size + 1, b].numpy(), sumsqs), b
        for t, k in zip(ts, ("window_length1", "window_length2")):
            want = t_host.compute_tstat(sums, sumsqs, s.size, params[k])
            assert np.array_equal(t[: s.size, b].numpy(), want), (b, k)
    stepped = ts[0][:, stepped_row]
    assert torch.isfinite(stepped).all() and float(stepped.max()) > 1e15


def test_event_tables_bitwise_vs_host(case):
    """detect_events_batch(device="cpu") against the host detect_events,
    read by read: start, length, mean and stdv bit for bit; an overflowing
    read gets None and its flag."""
    rna, sigs, batch, _, _, _ = case
    tables, overflow = ev.detect_events_batch(*batch, rna, device="cpu")
    unit = np.float32(RANGE) / np.float32(DIGI)
    n_over = 0
    for b, s in enumerate(sigs):
        if overflow[b]:
            assert tables[b] is None
            n_over += 1
            continue
        ref = t_host.detect_events((s.astype(np.float32) + np.float32(batch[3][b])) * unit, rna=rna)
        et = tables[b]
        assert et.n == ref.n, f"read {b}: {et.n} vs {ref.n} events"
        # bits, not values: an empty read's one event has mean 0 / 0
        for f in ("start", "length", "mean", "stdv"):
            assert np.array_equal(_bits(getattr(et, f)), _bits(getattr(ref, f))), (b, f)
    assert n_over == (0 if rna else 1)


def test_stage_functions_compose_to_detect_peaks(case):
    """On the CPU the four *_stage functions, each fed the one before,
    give detect_peaks' Peaks bit for bit; the t-stat planes are the
    plain tstat_plain's."""
    rna, _, batch, E, res, _ = case
    args = ev.batch_tensors(*batch, "cpu")
    A, Q, end_sum, end_sumsq = ev.prefix_stage(*args)
    t1, t2 = ev.tstat_stage(A, Q, args[1], rna)
    peaks, counts, overflow = ev.detector_stage(t1, t2, args[1], rna, E)
    psum, psumsq = ev.gather_stage(A, Q, peaks, counts, args[1])
    got = ev.Peaks(A, Q, peaks, counts, overflow, psum, psumsq, end_sum, end_sumsq)
    for name, g, w in zip(ev.Peaks._fields, got, res):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8)), name
    params = t_host.RNA_PARAMS if rna else t_host.DNA_PARAMS
    assert torch.equal(t2, ev.tstat_plain(A, Q, args[1], params["window_length2"]))


def test_stage_tstat_planes_bitwise_vs_jax(case):
    """tstat_stage's two planes equal sigfish_tpu's _tstat on the CPU
    backend (its window a traced f32), bit for bit, over every (i, b),
    padding rows included."""
    rna, _, batch, _, res, _ = case
    params = t_host.RNA_PARAMS if rna else t_host.DNA_PARAMS
    ns = torch.from_numpy(batch[1])
    got = ev.tstat_stage(res.A, res.Q, ns, rna)
    with jax.enable_x64(True):
        for g, k in zip(got, ("window_length1", "window_length2")):
            w = params[k]
            want = jax.jit(lambda A, Q, n, wf, w=w: j_ev._tstat(A, Q, n, w, wf))(
                jnp.asarray(res.A.numpy()), jnp.asarray(res.Q.numpy()), jnp.asarray(batch[1]),
                jnp.float32(w))
            assert np.array_equal(g.numpy().view(np.uint32), np.asarray(want).view(np.uint32)), k



@pytest.mark.parametrize("B", [0, 1, 7, 8, 9, 37, 40])
def test_lane_width_whole_chunks(B):
    """The card kernels run lane_width(B) reads wide: the least multiple
    of 8 (an i16 row of whole 16-byte chunks) not below B."""
    W = ev.lane_width(B)
    assert W % ev.LANE_ALIGN == 0 and B <= W < B + ev.LANE_ALIGN


@pytest.mark.parametrize("layout", ["as-is", "narrow", "strided", "unaligned"])
def test_pad_lanes(layout):
    """pad_lanes gives a contiguous, 16-byte-aligned (..., W) tensor with
    t's values and zero lanes past them; a tensor that is one already
    comes back as itself."""
    W = 40
    base = torch.arange(1, 3 * W + 2, dtype=torch.int16)
    t = {"as-is": base[: 3 * W].view(3, W), "narrow": base[: 3 * 37].view(3, 37),
         "strided": base[: 3 * W].view(W, 3).t(),
         "unaligned": base[1:].view(3, W)}[layout]
    assert (t.data_ptr() % 16 != 0) == (layout == "unaligned")
    p = ev.pad_lanes(t, W)
    B = t.shape[-1]
    assert tuple(p.shape) == (3, W) and p.is_contiguous() and p.data_ptr() % 16 == 0
    assert torch.equal(p[:, :B], t) and not p[:, B:].any()
    assert (p is t) == (layout == "as-is")


@pytest.mark.parametrize("stage", ["prefix", "tstat", "detector", "gather"])
@pytest.mark.parametrize("fault", ["strided", "dtype", "width"])
def test_stage_functions_refuse_bad_tensors(stage, fault):
    """A stage reads its tensors through raw pointers on the card, so on
    every device it refuses a non-contiguous tensor, a wrong dtype and a
    tensor of another batch width than nsamples."""
    ns = torch.full((8,), 10, dtype=torch.int32)
    good = {
        "prefix": [torch.zeros((64, 8), dtype=torch.int16), ns, torch.ones(8), torch.ones(8)],
        "tstat": [torch.zeros((65, 8), dtype=torch.float64)] * 2 + [ns, False],
        "detector": [torch.zeros((64, 8))] * 2 + [ns, False, 16],
        "gather": [torch.zeros((65, 8), dtype=torch.float64)] * 2
        + [torch.zeros((8, 16), dtype=torch.int32), ns, ns],
    }[stage]
    bad = list(good)
    first = bad[0]
    bad[0] = {"strided": first.t().contiguous().t(), "dtype": first.to(torch.float16),
              "width": first[..., :4].contiguous()}[fault]
    fn = {"prefix": ev.prefix_stage, "tstat": ev.tstat_stage, "detector": ev.detector_stage,
          "gather": ev.gather_stage}[stage]
    fn(*good)
    with pytest.raises(ValueError, match="want contiguous"):
        fn(*bad)


def test_event_batch_device_long_read_chunk_sizing(monkeypatch):
    """After sigfish_tpu's test of the same name: with the cell cap
    lowered, reads past it take the host path (_event_single) and are
    counted, a read whose padded plane reaches the cap gets a bucket of
    its own (Bb = 1), and every table equals _event_single's."""
    monkeypatch.setattr(tp, "_DEV_EVENT_CELL_CAP", 1 << 13)
    rng = np.random.default_rng(7)
    lens = [450, 550, 650, 4500, 6000, 8500, 10000, 350]
    works = []
    for i, n in enumerate(lens):
        n_ev = max(8, n // 40)
        x = np.repeat(rng.normal(90.0, 12.0, n_ev), rng.integers(10, 70, n_ev))[:n]
        x = np.pad(x, (0, max(0, n - x.size)), mode="edge")
        sig = np.clip(np.rint(x * DIGI / RANGE - OFF + rng.normal(0, 1.0, n)), -30000, 30000)
        w = tp.ReadWork()
        w.rec = Slow5Record(read_id=f"r{i}", read_group=0, digitisation=DIGI, offset=OFF,
                            range=RANGE, sampling_rate=4000.0, raw_signal=sig.astype(np.int16))
        works.append(w)
    buckets = [(sig.shape, len(chunk)) for chunk, sig, *_ in
               tp.event_buckets(works, [i for i, n in enumerate(lens) if n <= 1 << 13])]
    # Bb = min(64, max_b) with max_b = 8 at Sb = 1,024; 1 at Sb = 8,192
    assert buckets == [((8, 1024), 4), ((1, 8192), 1), ((1, 8192), 1)]
    opt = types.SimpleNamespace(rna=False, prefix_size=50, from_end=False)
    core = types.SimpleNamespace(opt=opt, host_stream=None, device=torch.device("cpu"),
                                 pore_flag=0, stage_wait=0.0, host_event_reads=0)
    tp._event_batch_device(core, works)
    assert core.host_event_reads == 2
    for i, n in enumerate(lens):
        ref = tp.ReadWork(rec=works[i].rec)
        tp._event_single(core, ref)
        w = works[i]
        assert w.n_events == ref.n_events and w.device_py is None, f"read {i} (len {n})"
        for f in ("event_start", "event_length", "event_mean"):
            assert np.array_equal(getattr(w, f), getattr(ref, f)), (i, f)


@pytest.fixture(scope="module")
def dna_runs(tmp_path_factory):
    """chip_smoke's R9 DNA workload at a small size, and R10's."""
    smoke = load_smoke()
    d, d10 = tmp_path_factory.mktemp("hs_dna"), tmp_path_factory.mktemp("hs_r10")
    return {"r9": smoke.make_workload(str(d), 2_000, 24, 10)[:2],
            "r10": smoke.make_workload(str(d10), 2_000, 24, 12, r10=True)[:2]}


@pytest.mark.parametrize("kind,kw", [
    ("r9", {}),
    ("r10", {}),
    ("r9", dict(from_end=True)),
], ids=["r9", "r10", "from_end"])
def test_host_stages_device_dna_byte_identical(dna_runs, kind, kw):
    """run_dtw with host_stages="device", device="cpu": the same bytes as
    sigfish_tpu's --host-stages device (native engine) and as the port's
    host mode."""
    fa, bl = dna_runs[kind]
    got, core = run_port(fa, bl, host_stages="device", batch_size=32, **kw)
    want_j, _ = run_jax(fa, bl, "native", host_stages="device", batch_size=32, **kw)
    want_h, _ = run_port(fa, bl, batch_size=32, **kw)
    assert got == want_j == want_h
    assert len(got.splitlines()) >= 20 and core.host_event_reads == 0


def test_host_stages_device_profile_cpu(dna_runs):
    """--profile-cpu's stage-by-stage branch with the device stages: the
    same bytes as the overlapped host mode, and its stage timers run."""
    fa, bl = dna_runs["r9"]
    got, core = run_port(fa, bl, host_stages="device", profile=True, batch_size=16)
    want, _ = run_port(fa, bl, batch_size=16)
    assert got == want
    assert core.event_time > 0 and core.normalise_time > 0 and core.parse_time > 0


def test_unknown_host_stages_rejected(dna_runs, capsys):
    """An unknown --host-stages value: Core raises SystemExit as the JAX
    package's does, and the CLI's parser refuses it."""
    fa, bl = dna_runs["r9"]
    with pytest.raises(SystemExit, match="unknown --host-stages 'bogus'"):
        tp.Core(fa, bl, tp.Options(device="cpu", host_stages="bogus"))
    with pytest.raises(SystemExit) as e:
        cli.main(["dtw", fa, bl, "--device", "cpu", "--host-stages", "bogus"])
    assert e.value.code == 2 and "invalid choice: 'bogus'" in capsys.readouterr().err
