"""Reduce a torch.profiler Chrome trace of the measured window to what
the per-layer readers need.

- busy_s: the union of the device's activity (kernels, copies, fills)
  inside the window's own range.
- range_kernel_s: for each harness range (record_function), the summed
  device time of the kernels launched while the launching thread was
  inside it; a kernel is tied to its launch by the trace's correlation id,
  so the sum does not depend on kernel names.
- device_ops: the device operations that took most time, by name.
- idle_gaps: the device's idle time inside the window, by the innermost
  harness range the main thread was in at each gap's middle.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160  # a kernel's name as the breakdown gives it


def _union(iv: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(spans: list[tuple[float, float]], starts: list[float], t: float) -> bool:
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and spans[k][0] <= t <= spans[k][1]


def reduce(path: str, window: str, ranges: list[str]) -> dict:
    """What the trace at `path` says of the range named `window`, opened
    on the main thread, and of each range in `ranges` (outermost first)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    annots = defaultdict(list)  # (tid, name) -> spans
    launches = []               # (tid, ts, correlation)
    device = []                 # (start, end, name, correlation, category)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            annots[(e.get("tid"), e["name"])].append((ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches.append((e.get("tid"), ts, e["args"]["correlation"]))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, e["name"], e.get("args", {}).get("correlation"), cat))
    wins = [(s, tid) for (tid, name), v in annots.items() if name == window for s in v]
    if not wins or not device:
        return {}
    main_tid = wins[0][1]
    wins = [s for s, _ in wins]
    w0, w1 = min(a for a, _ in wins), max(b for _, b in wins)
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    busy = _union([(max(a, w0), min(b, w1)) for a, b, *_ in device])
    busy_us = sum(b - a for a, b in busy)

    # kernels by the range their launch was made in
    spans = {}
    for (tid, name), v in annots.items():
        if name in ranges:
            v = _union(v)
            spans[(tid, name)] = (v, [a for a, _ in v])
    corr_range = {}
    for tid, ts, corr in launches:
        for name in ranges:
            sp = spans.get((tid, name))
            if sp and _inside(sp[0], sp[1], ts):
                corr_range[corr] = name
    range_us = defaultdict(float)
    by_name = defaultdict(float)
    for a, b, name, corr, cat in device:
        by_name[name] += b - a
        if cat == "kernel" and corr in corr_range:
            range_us[corr_range[corr]] += b - a

    # idle gaps inside the window, by what the main thread was inside
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = defaultdict(float)
    main = {name: spans[(main_tid, name)] for name in ranges if (main_tid, name) in spans}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        label = "other"
        for name in ranges:  # innermost last
            if name in main and _inside(main[name][0], main[name][1], mid):
                label = name
        gaps[label] += b - a
    top = [(n[:NAME_CHARS], v) for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    return dict(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        range_kernel_s={k: v / 1e6 for k, v in range_us.items()},
        device_ops=[[n, v / 1e6] for n, v in top],
        idle_gaps=[[n, v / 1e6] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    )
