"""The port's trace spans (sigfish_tpu_torch/runtime/trace.py) on the CPU:
run_dtw opens no range while no profiler records; under torch.profiler
with every thread profiled, the Chrome trace holds each sf.* span of the
run's route on the thread the schedule puts it on, nested in its batch's
spans; the output does not change; and the Core's counts add up.

Workload: chip_smoke's DNA reads (tests/test_torch_distributed.py's
generator), 80 reads in batches of 40, so the pool maps each batch's
reads in chunks and the first batch drains on the drain thread."""

from __future__ import annotations

import io
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_runs import load_smoke
from sigfish_tpu_torch import native
from sigfish_tpu_torch.runtime import pipeline as pl
from sigfish_tpu_torch.runtime import trace

K = 40


@pytest.fixture(scope="module")
def dna(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace_dna")
    return load_smoke().make_workload(str(d), 600, 2 * K, 7)[:2]


def _run(fa, bl, traced_to=None, **opt):
    """(PAF, Core) of one run_dtw on the CPU; with traced_to, under
    torch.profiler on every thread, its Chrome trace written there."""
    opt = {"batch_size": K, "num_thread": 2, **opt}
    core = pl.Core(fa, bl, pl.Options(device="cpu", **opt))
    out = io.StringIO()
    if traced_to is None:
        pl.run_dtw(core, out)
    else:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=trace.profile_all_threads()) as prof:
            pl.run_dtw(core, out)
        prof.export_chrome_trace(str(traced_to))
    core.close()
    return out.getvalue(), core


def _spans(path) -> dict[str, list[tuple[int, float, float]]]:
    """Each sf.* name's ranges in the Chrome trace: (tid, start, end)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[str, list] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("sf."):
            ts = float(e["ts"])
            out.setdefault(e["name"], []).append((e["tid"], ts, ts + float(e.get("dur", 0.0))))
    return out


def _inside(inner, outer) -> bool:
    """Every range of `inner` lies in time inside some range of `outer`."""
    return all(any(a <= s and e <= b for _, a, b in outer) for _, s, e in inner)


@pytest.fixture(scope="module")
def plain(dna):
    return _run(*dna, engine="native")


def test_untraced_run_opens_no_range(dna, plain, monkeypatch):
    """With no profiler recording, a run on two threads never enters
    record_function, and every span is the one shared no-op."""
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    trace.reset()
    assert trace.span("sf.prep") is trace.span("sf.decode")
    assert _run(*dna, engine="native")[0] == plain[0]
    assert trace.totals() == {}


def test_traced_run_has_every_span_on_its_thread(dna, plain, tmp_path):
    """The native engine's route: sf.read, sf.prep, sf.sdtw_queue and
    sf.drain_wait on the caller's thread; sf.decode, sf.events and
    sf.normalise on pool threads, a span each a pool chunk, inside an
    sf.prep; sf.collect,
    sf.backtrack, sf.format and sf.output on one other thread (the
    drain's; the last batch drains on the caller's). The PAF is the
    untraced run's, byte for byte, and totals() counts what the trace
    holds."""
    path = tmp_path / "t.json"
    trace.reset()
    paf, _ = _run(*dna, traced_to=path, engine="native")
    assert paf == plain[0]
    sp = _spans(path)
    main = threading.get_native_id()
    for name in ("sf.read", "sf.prep", "sf.sdtw_queue", "sf.drain_wait"):
        assert sp.get(name) and {t for t, _, _ in sp[name]} == {main}, name
    for name in ("sf.decode", "sf.events", "sf.normalise"):
        assert sp.get(name) and {t for t, _, _ in sp[name]} - {main}, name
        assert _inside(sp[name], sp["sf.prep"]), name
    drains = {name: {t for t, _, _ in sp[name]} - {main}
              for name in ("sf.collect", "sf.backtrack", "sf.format", "sf.output")}
    assert all(len(t) == 1 for t in drains.values()) and len(set.union(*drains.values())) == 1
    assert len(sp["sf.decode"]) == 4  # a span a pool chunk: 32 + 8 records a batch
    assert {k: n for k, (_, n) in trace.totals().items()} == {k: len(v) for k, v in sp.items()}


@pytest.mark.parametrize("ref_chunk,route", [(-1, "oneshot"), (600, "chunked")])
def test_traced_route_span_inside_the_queue(dna, tmp_path, ref_chunk, route):
    """The wavefront's routes: Core._span's sf.sdtw.<route> lies inside
    sf.sdtw_queue on the caller's thread (one batch: the plain kernel's
    every op is in the trace); the PAF is the untraced run's."""
    path = tmp_path / "t.json"
    paf, core = _run(*dna, traced_to=path, ref_chunk=ref_chunk, rec_limit=8, batch_size=8)
    assert core.routes[route] == 1
    assert paf == _run(*dna, ref_chunk=ref_chunk, rec_limit=8, batch_size=8)[0]
    sp = _spans(path)
    main = threading.get_native_id()
    assert len(sp["sf.sdtw." + route]) == 1 and sp["sf.sdtw." + route][0][0] == main
    assert _inside(sp["sf.sdtw." + route], sp["sf.sdtw_queue"])


@pytest.mark.parametrize("native_decode", [True, False])
def test_counts_add_up(dna, plain, monkeypatch, native_decode):
    """Records decoded natively plus in Python are total_reads (all in
    Python when the native decoder declines every record); live plus
    padded rows are the submitted buckets, 64 a batch here."""
    if not native_decode:
        monkeypatch.setattr(native, "_blow5_decode", lambda *a: None)
    elif not native.available():
        pytest.skip("the native library is not built here")
    paf, core = _run(*dna, engine="native") if not native_decode else plain
    assert paf == plain[0]
    c = core.counts
    assert c["decode_native"] + c["decode_python"] == core.total_reads == 2 * K
    assert c["decode_native"] == (2 * K if native_decode else 0)
    assert c["rows_live"] == core.total_reads - core.ignored
    assert c["rows_live"] + c["rows_padded"] == 64 * 2


def test_span_totals_while_recording():
    """A span closed while a profiler records adds its seconds and one
    to its name's totals; reset() clears them."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with trace.span("sf.output"):
                pass
    s, n = trace.totals()["sf.output"]
    assert n == 3 and s >= 0.0
    trace.reset()
    assert trace.totals() == {}


def test_span_totals_from_many_threads():
    """Spans closed on more threads than cores, with the interpreter
    switching threads as often as it can, lose no count."""
    import concurrent.futures as cf
    import os
    import sys

    n_threads, n_spans = 4 * (os.cpu_count() or 1), 200
    trace.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with cf.ThreadPoolExecutor(n_threads) as pool:
                def work():
                    for _ in range(n_spans):
                        with trace.span("sf.decode"):
                            pass
                futs = [pool.submit(work) for _ in range(n_threads)]
                for f in futs:
                    f.result(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert trace.totals()["sf.decode"][1] == n_threads * n_spans
    trace.reset()
