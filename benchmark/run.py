#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names a configuration (its `file`) and a traffic mix
(benchmark/traffic/<traffic>.json); each metric is read by
benchmark/metrics/<metric>.py. The run makes the cell's FASTA and BLOW5
file from the seed (under build/benchmark/<cell>/ in the checkout; not
counted in set-up), then set-up builds the mapper's state and maps two
batches to build and warm every kernel. The window then runs sigfish_tpu_torch's run_dtw over the file,
pass after pass, each pass a new Core on the set-up's CoreState, and
stops handing it records once --seconds have passed; it ends when the
last records handed out are mapped. Then a sample of the reads is mapped
again by the plain reference and compared (check.py).

--trace 0 prints the cell's end-to-end metrics. --trace 1 runs the window
under torch.profiler instead, then one window of profile=True passes (the
mapper's stage timers, each batch drained before the next), and prints
the per-layer metrics.

Exits non-zero, with no result, without a CUDA card (or fewer than the
cell asks for), or if JAX or the JAX package was imported.
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel caches inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "sigfish_tpu")
RANGES = ["read_batch", "submit_batch", "sdtw_submit", "finish_batch"]
WARM_BATCHES = 2


def process_start() -> float:
    """This process's start on the wall clock (Linux /proc), or the
    import of this file where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return T_IMPORT


def resolve(root: str, workload: str) -> dict:
    """The cell `workload` of root/BENCHMARK.json: its entry, its
    configuration and traffic, and its metrics (end to end and per layer,
    each with its reader's `read`)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def metrics(kind):
        return [dict(m, read=_reader(root, m["name"])) for m in bench[kind]]

    return dict(cell=cell, config=config, traffic=traffic, end_to_end=metrics("end_to_end"),
                per_layer=metrics("per_layer"))


def _reader(root: str, name: str):
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Feed:
    """The Core's BLOW5 file, which hands out no more records once the
    window's time is up; counts what it handed out."""

    def __init__(self, sf, deadline: float, ranged: bool):
        self._sf, self.deadline, self.ranged, self.fed = sf, deadline, ranged, 0

    def read_batch(self, *a, **kw):
        if time.time() >= self.deadline:
            return []
        with _range("read_batch", self.ranged):
            blobs = self._sf.read_batch(*a, **kw)
        self.fed += len(blobs)
        return blobs

    def __getattr__(self, name):
        return getattr(self._sf, name)


def _range(name: str, on: bool):
    import contextlib

    import torch

    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _ranged(fn, name):
    def wrapper(*a, **kw):
        with _range(name, True):
            return fn(*a, **kw)
    return wrapper


def passes(pl, data: dict, opt, state, seconds: float, ranged: bool = False) -> dict:
    """run_dtw over the file, pass after pass, each a new Core on `state`,
    until `seconds` have passed; the last pass stops taking records then
    and ends when they are mapped. With ranged, each batch's read, submit
    and finish and the sDTW submit are record_function ranges."""
    import torch

    sync = torch.cuda.synchronize if opt.device == "cuda" else (lambda: None)
    saved = pl.submit_batch, pl.finish_batch
    if ranged:
        pl.submit_batch = _ranged(saved[0], "submit_batch")
        pl.finish_batch = _ranged(saved[1], "finish_batch")
    out = []
    t0 = time.time()
    deadline = t0 + seconds
    try:
        while True:
            tp = time.time()
            core = pl.Core(data["fasta"], data["blow5"], opt, state=state)
            core.sf = feed = Feed(core.sf, deadline, ranged)
            if ranged:
                core.sdtw_candidates_submit = _ranged(core.sdtw_candidates_submit, "sdtw_submit")
            buf = io.StringIO()
            pl.run_dtw(core, buf)
            sync()
            p = dict(text=buf.getvalue(), fed=feed.fed, done=core.total_reads,
                     parse_s=core.parse_time, event_s=core.event_time,
                     normalise_s=core.normalise_time, sdtw_device_s=0.0)
            if opt.profile and opt.device == "cuda":
                p["sdtw_device_s"] = core.span_seconds("oneshot") + core.span_seconds("chunked")
            core.close()
            p["seconds"] = time.time() - tp
            out.append(p)
            if time.time() >= deadline:
                break
    finally:
        pl.submit_batch, pl.finish_batch = saved
    t1 = time.time()
    return dict(passes=out, window_s=t1 - t0, done=sum(p["done"] for p in out))


def host_cpu() -> dict:
    """This process's CPU seconds, and the machine's jiffies by kind
    (/proc/stat: user, nice, system, idle, iowait, irq, softirq, steal)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"self_s": ru.ru_utime + ru.ru_stime}
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:9]]
        out.update(zip(("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal"), v))
    except (OSError, ValueError):
        pass
    return out


def cpu_line(a: dict, b: dict, window_s: float) -> str:
    """How the window used the host: this process's CPU seconds a second,
    and the machine's busy, idle and stolen shares (steal: time the
    hypervisor gave the machine's CPUs to others)."""
    line = f"host cpu: this process {(b['self_s'] - a['self_s']) / window_s:.2f} CPUs"
    if "steal" in a and "steal" in b:
        d = {k: b[k] - a[k] for k in a if k != "self_s"}
        tot = sum(d.values()) or 1
        busy = tot - d["idle"] - d["iowait"] - d["steal"]
        line += (f"; machine ({os.cpu_count()} CPUs) busy {100 * busy / tot:.1f}%, "
                 f"idle {100 * (d['idle'] + d['iowait']) / tot:.1f}%, steal {100 * d['steal'] / tot:.1f}%")
    return line


def mapper_options(pl, config: dict, device: str):
    """The mapper's Options from every key of the configuration's `mapper`
    section that is one of their fields (others, such as `pore`, are the
    reference's)."""
    fields = {f.name for f in dataclasses.fields(pl.Options)}
    return pl.Options(**{k: v for k, v in config["mapper"].items() if k in fields}, device=device)


def traced_window(pl, data, opt, state, seconds: float, scratch: str) -> tuple[dict, dict]:
    """One window under torch.profiler (CPU and CUDA activity), reduced by
    trace.py; the Chrome trace is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if opt.device == "cuda" else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("window"):
            win = passes(pl, data, opt, state, seconds, ranged=True)
    path = os.path.join(scratch, "window.pt.trace.json")
    prof.export_chrome_trace(path)
    try:
        red = trace.reduce(path, "window", RANGES)
    finally:
        os.remove(path)
    return win, red


def decode_paths(data: dict) -> str:
    """Whether the mapper's native library decodes this file's records
    (else they decode in Python): one record tried, as all share the
    file's compression."""
    from sigfish_tpu_torch import native
    from sigfish_tpu_torch.io.blow5 import Slow5File

    with Slow5File(data["blow5"]) as sf:
        blob = sf.read_batch(1, 1 << 30)[0]
        native_ok = native.blow5_decode(blob, sf.rec_press, sf.sig_press) is not None
        press = f"records {sf.rec_press}, signal {sf.sig_press}"
    n = len(data["reads"])
    return f"decode ({press}): {n if native_ok else 0} records a pass native, {0 if native_ok else n} in Python"


def run(argv=None, device: str = "cuda", root: str = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_proc = process_start()
    spec = resolve(root, args.workload)
    chips = spec["cell"]["chips"]

    import torch

    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch finds {found}", file=sys.stderr)
        return 3

    from benchmark import check, traffic
    from sigfish_tpu_torch.runtime import pipeline as pl

    scratch = os.path.join(root, "build", "benchmark", args.workload)
    steps = {"imports": time.time() - t_proc}
    t = time.time()
    data = traffic.generate(spec["config"], spec["traffic"], args.seed, scratch)
    opt = mapper_options(pl, spec["config"], device)
    steps["inputs"] = time.time() - t

    # set-up: the state, then two batches through every kernel and shape;
    # making the inputs is the benchmark's own work and not set-up
    t = time.time()
    probe = pl.Core(data["fasta"], data["blow5"], opt)
    state = probe.state
    probe.close()
    steps["state"] = time.time() - t
    t = time.time()
    warm = pl.Core(data["fasta"], data["blow5"],
                   dataclasses.replace(opt, rec_limit=WARM_BATCHES * opt.batch_size), state=state)
    pl.run_dtw(warm, io.StringIO())
    warm.close()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    steps["warm-up"] = time.time() - t
    t_setup = time.time() - t_proc - steps["inputs"]

    host0 = host_cpu()
    if args.trace:
        win, red = traced_window(pl, data, opt, state, args.seconds, scratch)
        prof = passes(pl, data, dataclasses.replace(opt, profile=True), state, args.seconds)
    else:
        win, red, prof = passes(pl, data, opt, state, args.seconds), {}, None
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    host1 = host_cpu()
    del state, probe, warm
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"benchmark: modules of JAX or the JAX package were imported: {found}", file=sys.stderr)
        return 4

    # correctness: a sample of the window's reads against the reference
    from benchmark.reference import mapper

    t_check = time.time()
    n_done = max(p["fed"] for p in win["passes"])
    picked = check.sample(data["reads"], n_done, args.seed)
    expect, info = mapper.map_reads([data["reads"][i] for i in picked], data["contigs"],
                                    spec["config"]["mapper"], device=device)
    numbers = check.judge(data["reads"], picked, expect, win["passes"])
    correct = check.verdict(numbers)
    t_check = time.time() - t_check

    ctx = types.SimpleNamespace(
        setup_s=t_setup, window_s=win["window_s"], reads_done=win["done"], peak_bytes=peak,
        trace=red, stages=None, sdtw_qlens=None, ref_columns=None, issue_rate=None,
    )
    if args.trace:
        ctx.stages = dict(reads=sum(p["done"] for p in prof["passes"]),
                          **{k: sum(p[k] for p in prof["passes"])
                             for k in ("parse_s", "event_s", "normalise_s", "sdtw_device_s")})
        ctx.sdtw_qlens, ctx.ref_columns = sdtw_work(data, spec["config"], win["passes"])
        if device == "cuda":
            from benchmark import roofline

            ctx.issue_rate = roofline.f32_issue_rate()[0]
    metrics = {}
    for m in spec["per_layer" if args.trace else "end_to_end"]:
        v = m["read"](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    if args.trace:
        dev.update(busy_s=red.get("busy_s", 0.0), window_s=red.get("window_s", win["window_s"]))
    result = {"correct": correct, "attempted": win["done"], "failed": numbers["lost_reads"],
              "metrics": metrics, "device": dev}
    if args.trace and red:
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}

    print(decode_paths(data), file=sys.stderr)
    each = ", ".join(f"{p['done']} in {p['seconds']:.3f} s" for p in win["passes"])
    print(f"window: {len(win['passes'])} passes ({each}), {win['done']} reads in {win['window_s']:.3f} s; "
          f"set-up {t_setup:.3f} s (" + ", ".join(f"{k} {v:.3f}" for k, v in steps.items() if k != "inputs")
          + f"); inputs {steps['inputs']:.3f} s, not set-up; reference {t_check:.3f} s: {info}",
          file=sys.stderr)
    print(cpu_line(host0, host1, win["window_s"]), file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def sdtw_work(data: dict, config: dict, passes_: list[dict]) -> tuple[list[int], int]:
    """The sDTW work the window's reads need: the query length (by the
    reference's eventizer) of every record handed out in every pass that
    reaches the sDTW, and the reference's columns. Padding is not counted."""
    from benchmark.reference import host, tracks

    m = config["mapper"]
    n = max(p["fed"] for p in passes_)
    qs = host.queries(data["reads"][:n], m["rna"], m["prefix_size"], m["query_size"])
    cols = sum(t.size for _, _, t in tracks.make_tracks(
        data["contigs"], m["pore"], m["rna"], m["query_size"])["tracks"])
    per = [0 if q.skip else q.query.size for q in qs]
    return [x for p in passes_ for x in per[: p["fed"]] if x], cols


if __name__ == "__main__":
    sys.exit(run())
