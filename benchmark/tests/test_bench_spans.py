"""benchmark/spans.py and the span readers: reduce() on a hand-written
Chrome trace (the sf.* spans by thread, the device operations launched
inside the sDTW's spans, the idle time by span), trace.reduce unmoved by
the sf.* spans, each reader against the mapper's span totals (and None
where the mapper has no spans), and a whole CPU run whose traced window
reports every reader."""

from __future__ import annotations

import json
import sys
import time
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import run, spans, trace
from test_bench_harness import ROOT, _run_cpu, _tiny_root

READERS = {
    "prep_ms_per_read": ("sf.prep",),
    "decode_thread_ms_per_read": ("sf.decode",),
    "host_stages_thread_ms_per_read": ("sf.events", "sf.normalise"),
    "sdtw_queue_ms_per_read": ("sf.sdtw_queue",),
    "drain_host_ms_per_read": ("sf.backtrack", "sf.format", "sf.output"),
}


def _x(name, tid, ts, dur, cat="user_annotation", corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# the window (0-100 us) on thread 1; pool threads 2 and 3; drain thread 4
HARNESS = [_x("window", 1, 0, 100), _x("submit_batch", 1, 0, 50), _x("sdtw_submit", 1, 30, 20)]
SF = [
    _x("sf.prep", 1, 0, 30), _x("sf.decode", 2, 5, 10), _x("sf.decode", 3, 8, 10),
    _x("sf.sdtw_queue", 1, 30, 20), _x("sf.sdtw.chunked", 1, 32, 16),
    _x("sf.drain_wait", 1, 50, 20),
    _x("sf.collect", 4, 52, 15), _x("sf.backtrack", 4, 67, 5), _x("sf.format", 4, 72, 3),
    _x("sf.output", 4, 75, 1),
]
DEVICE = [
    _x("cudaLaunchKernel", 1, 33, 1, "cuda_runtime", 1), _x("k1", 7, 35, 10, "kernel", 1),
    _x("cudaLaunchKernel", 1, 40, 1, "cuda_runtime", 2), _x("k2", 7, 45, 10, "kernel", 2),
    _x("cudaMemcpyAsync", 1, 49, 1, "cuda_runtime", 3), _x("copy", 7, 60, 5, "gpu_memcpy", 3),
    _x("cudaLaunchKernel", 4, 80, 1, "cuda_runtime", 4), _x("k3", 7, 85, 5, "kernel", 4),
]


def _write(tmp_path, events) -> str:
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def test_reduce_sf_spans(tmp_path):
    r = spans.reduce(_write(tmp_path, HARNESS + SF + DEVICE), "window")
    assert r["window_s"] == pytest.approx(100e-6) and r["busy_s"] == pytest.approx(30e-6)
    s = r["spans"]
    assert s["sf.prep"] == pytest.approx({"main_s": 30e-6, "all_s": 30e-6, "count": 1})
    assert s["sf.decode"] == pytest.approx({"main_s": 0.0, "all_s": 20e-6, "count": 2})
    assert s["sf.collect"] == pytest.approx({"main_s": 0.0, "all_s": 15e-6, "count": 1})
    assert set(s) == {e["name"] for e in SF}
    # launched inside the queue: both kernels and the copy; inside the
    # route's span the two kernels; the drain thread's kernel in neither
    assert r["launched"]["sf.sdtw_queue"] == pytest.approx(
        {"ops": 3, "ranges": 1, "device_s": 25e-6, "busy_s": 25e-6, "extent_s": 30e-6})
    assert r["launched"]["sf.sdtw.chunked"] == pytest.approx(
        {"ops": 2, "ranges": 1, "device_s": 20e-6, "busy_s": 20e-6, "extent_s": 20e-6})
    # idle 0-35 in sf.prep, 55-60 in sf.drain_wait, 65-85 and 90-100 in none
    assert r["idle_by_span"] == pytest.approx({"sf.prep": 35e-6, "other": 30e-6,
                                               "sf.drain_wait": 5e-6})


def test_reduce_innermost_span_and_no_window(tmp_path):
    """An idle gap inside a route's span inside the queue's goes to the
    route's; a trace without the window reduces to {}."""
    events = [_x("window", 1, 0, 10), _x("sf.sdtw_queue", 1, 0, 10), _x("sf.sdtw.oneshot", 1, 2, 6),
              _x("k", 7, 0, 4, "kernel", 9), _x("k", 7, 8.5, 0.5, "kernel", 10)]
    r = spans.reduce(_write(tmp_path, events), "window")
    assert r["idle_by_span"] == pytest.approx({"sf.sdtw.oneshot": 4.5e-6, "sf.sdtw_queue": 1e-6})
    assert spans.reduce(_write(tmp_path, SF + DEVICE), "window") == {}


def test_trace_reduce_unmoved_by_sf_spans(tmp_path):
    """run.py's reduction reads the same with the sf.* spans in the trace
    as without them."""
    with_sf = trace.reduce(_write(tmp_path, HARNESS + SF + DEVICE), "window", run.RANGES)
    without = trace.reduce(_write(tmp_path, HARNESS + DEVICE), "window", run.RANGES)
    assert with_sf == without
    assert with_sf["range_kernel_s"] == pytest.approx({"sdtw_submit": 20e-6})
    assert dict(with_sf["idle_gaps"]) == pytest.approx({"submit_batch": 35e-6, "other": 35e-6})


def test_readers_read_the_window_s_spans():
    """Each reader gives its spans' milliseconds a record since it was
    loaded: spans closed before are left out."""
    from sigfish_tpu_torch.runtime import trace as sft

    names = sorted({n for ns in READERS.values() for n in ns})
    with profile(activities=[ProfilerActivity.CPU]):
        for n in names:
            with sft.span(n):
                time.sleep(0.002)
    before = sft.totals()
    readers = {m: run._reader(ROOT, m) for m in READERS}
    with profile(activities=[ProfilerActivity.CPU]):
        for n in names:
            with sft.span(n):
                time.sleep(0.001)
    after = sft.totals()
    ctx = types.SimpleNamespace(reads_done=4)
    for m, ns in READERS.items():
        want = 1e3 * sum(after[n][0] - before[n][0] for n in ns) / 4
        assert readers[m](ctx) == pytest.approx(want) and want >= 0.25 * len(ns)
    assert all(r(types.SimpleNamespace(reads_done=0)) is None for r in readers.values())


def test_readers_give_none_without_the_mapper_s_spans(monkeypatch):
    """Over a checkout whose mapper has no span module, every reader
    gives None and does not raise."""
    import sigfish_tpu_torch.runtime as rt

    monkeypatch.delattr(rt, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "sigfish_tpu_torch.runtime.trace", None)
    assert spans.snapshot() is None
    ctx = types.SimpleNamespace(reads_done=4)
    assert all(run._reader(ROOT, m)(ctx) is None for m in READERS)


def test_traced_cpu_run_reports_every_span_reader(tmp_path, capsys):
    res = _run_cpu(_tiny_root(tmp_path), capsys, trace=1)
    assert res["correct"] is True
    assert set(READERS) <= set(res["metrics"])
    assert all(res["metrics"][m]["value"] > 0 and res["metrics"][m]["unit"] == "ms/read"
               for m in READERS)
