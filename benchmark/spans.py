#!/usr/bin/env python3
"""The mapper's own spans (sigfish_tpu_torch/runtime/trace.py: sf.read,
sf.prep, sf.sdtw_queue, sf.drain_wait on the thread that runs the batch
loop; sf.decode, sf.events, sf.normalise on its pool; sf.collect,
sf.backtrack, sf.format, sf.output on its drain thread) as the benchmark
reads them.

- snapshot() and ms_per_read(): the span readers' source. The mapper
  sums each span's host seconds while a torch.profiler records, that is
  in run.py's traced window alone; a reader takes a snapshot when it is
  loaded (before the window) and reads the named spans' seconds since,
  per record of the window. Both give None where the mapper has no such
  spans (an older checkout).
- reduce(): the sf.* ranges of a Chrome trace of a window: per name the
  summed duration on the window's thread and on any, and the count; the
  device operations launched inside sf.sdtw_queue and inside each
  sf.sdtw.<route> (tied by correlation id, as trace.py ties kernels to
  the harness's ranges), and each route's device time, busy union and
  extent; and the device's idle time inside the window by the innermost
  sf.* range the window's thread was in at each gap's middle.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> [--profile 0|1]

runs one untraced window, then one window under torch.profiler with
every thread profiled (as run.py's, with its ranges), and prints one
JSON line: both windows' reads/s, trace.reduce's and reduce()'s output,
and the mapper's span totals. --profile 1 runs the windows with the
mapper's profile=True (each batch drained before the next, the sDTW
routes' CUDA-event spans on).
"""

from __future__ import annotations

import bisect
import json
import os
import sys
from collections import defaultdict

if not __package__:  # run as a script, from the checkout's root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.trace import DEVICE_CATS, LAUNCH_CATS, _inside, _union  # noqa: E402

PREFIX = "sf."


def snapshot() -> dict | None:
    """The mapper's span totals now, {name: (seconds, count)}; None
    without its span module."""
    try:
        from sigfish_tpu_torch.runtime import trace
    except ImportError:
        return None
    return trace.totals()


def ms_per_read(ctx, names: tuple[str, ...], base: dict | None) -> float | None:
    """The named spans' host milliseconds since `base` (a snapshot()) per
    record of the traced window; None without spans."""
    now = snapshot()
    if now is None or base is None or not ctx.reads_done:
        return None
    sec = n = 0
    for k in names:
        s1, n1 = now.get(k, (0.0, 0))
        s0, n0 = base.get(k, (0.0, 0))
        sec, n = sec + s1 - s0, n + n1 - n0
    return 1e3 * sec / ctx.reads_done if n else None


def reduce(path: str, window: str) -> dict:
    """What the Chrome trace at `path` says of the sf.* ranges inside the
    range named `window` (see the module's docstring); {} without it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    annots = defaultdict(list)  # (tid, name) -> ranges
    launches = []               # (tid, ts, correlation)
    device = []                 # (start, end, correlation)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and (e["name"] == window or e["name"].startswith(PREFIX)):
            annots[(e.get("tid"), e["name"])].append((ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches.append((e.get("tid"), ts, e["args"]["correlation"]))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("args", {}).get("correlation")))
    wins = [(r, tid) for (tid, name), v in annots.items() if name == window for r in v]
    if not wins:
        return {}
    main_tid = wins[0][1]
    w0, w1 = min(a for (a, _), _ in wins), max(b for (_, b), _ in wins)

    spans = defaultdict(lambda: {"main_s": 0.0, "all_s": 0.0, "count": 0})
    for (tid, name), v in annots.items():
        if name == window:
            continue
        for a, b in v:
            if b > w0 and a < w1:
                s = spans[name]
                s["all_s"] += (b - a) / 1e6
                s["main_s"] += (b - a) / 1e6 if tid == main_tid else 0.0
                s["count"] += 1

    # device operations by the sf.* range their launch was made in (the
    # launching thread's innermost: a route's inside the queue's)
    ranges = {}
    for (tid, name), v in annots.items():
        if name.startswith(PREFIX + "sdtw"):
            v = sorted(v)
            ranges[(tid, name)] = (v, [a for a, _ in v])
    corr = defaultdict(list)  # name -> [(correlation, range index)]
    for tid, ts, c in launches:
        for (rt, name), (v, starts) in ranges.items():
            k = bisect.bisect_right(starts, ts) - 1
            if rt == tid and k >= 0 and v[k][0] <= ts <= v[k][1]:
                corr[name].append((c, k))
    dev = {c: (a, b) for a, b, c in device if c is not None}
    launched = {}
    for name, cs in corr.items():
        ops = [(dev[c], k) for c, k in cs if c in dev]
        busy = sum(b - a for a, b in _union([iv for iv, _ in ops]))
        ext = defaultdict(lambda: [float("inf"), float("-inf")])
        for (a, b), k in ops:
            ext[k][0], ext[k][1] = min(ext[k][0], a), max(ext[k][1], b)
        launched[name] = dict(
            ops=len(ops), ranges=sum(len(ranges[r][0]) for r in ranges if r[1] == name),
            device_s=sum(b - a for (a, b), _ in ops) / 1e6, busy_s=busy / 1e6,
            extent_s=sum(b - a for a, b in ext.values()) / 1e6)

    # idle gaps inside the window, by the innermost sf.* range of the
    # window's thread at each gap's middle
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in device if b > w0 and a < w1])
    main = {}
    for (tid, name), v in annots.items():
        if tid == main_tid and name != window:
            v = _union(v)
            main[name] = (v, [a for a, _ in v])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, label, width = (a + b) / 2, "other", float("inf")
        for name, (v, starts) in main.items():
            if _inside(v, starts, mid):
                k = bisect.bisect_right(starts, mid) - 1
                if v[k][1] - v[k][0] < width:
                    label, width = name, v[k][1] - v[k][0]
        idle[label] += (b - a) / 1e6
    return dict(
        window_s=(w1 - w0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6,
        spans={k: dict(v) for k, v in sorted(spans.items())}, launched=launched,
        idle_by_span=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
    )


def main(argv=None) -> int:
    import argparse
    import dataclasses
    import io
    import time

    from benchmark import run, trace, traffic

    root = run.ROOT

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from sigfish_tpu_torch.runtime import pipeline as pl
    from sigfish_tpu_torch.runtime import trace as sft

    spec = run.resolve(root, args.workload)
    scratch = os.path.join(root, "build", "benchmark", args.workload)
    data = traffic.generate(spec["config"], spec["traffic"], args.seed, scratch)
    opt = dataclasses.replace(run.mapper_options(pl, spec["config"], args.device),
                              profile=bool(args.profile))
    core = pl.Core(data["fasta"], data["blow5"], opt)
    state = core.state
    core.close()
    warm = pl.Core(data["fasta"], data["blow5"],
                   dataclasses.replace(opt, rec_limit=run.WARM_BATCHES * opt.batch_size), state=state)
    pl.run_dtw(warm, io.StringIO())
    warm.close()

    plain = run.passes(pl, data, opt, state, args.seconds)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if opt.device == "cuda" else [])
    sft.reset()
    t = time.time()
    with profile(activities=acts, experimental_config=sft.profile_all_threads()) as prof:
        with torch.profiler.record_function("window"):
            win = run.passes(pl, data, opt, state, args.seconds, ranged=True)
    stop_s = time.time() - t - win["window_s"]
    path = os.path.join(scratch, "spans.pt.trace.json")
    prof.export_chrome_trace(path)
    try:
        out = dict(
            reads_per_s=dict(untraced=plain["done"] / plain["window_s"],
                             traced=win["done"] / win["window_s"]),
            reads=dict(untraced=plain["done"], traced=win["done"]),
            profiler_stop_s=stop_s, harness=trace.reduce(path, "window", run.RANGES),
            sf=reduce(path, "window"), totals=sft.totals(),
        )
    finally:
        os.remove(path)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
