"""Spans of the batch loop, for torch.profiler.

span(name) marks one stage of run_dtw (decode, host stages, the sDTW's
queuing, the drain) on whichever thread runs it. While a torch.profiler
records, it opens torch.profiler.record_function(name), so the range
sits in the profiler's own trace on the clock of the device's kernels,
copies and fills, and each device idle gap can be put down to what each
host thread was doing; it also adds the span's host seconds to totals().
Otherwise it returns one shared no-op context: no allocation, no clock
read, no torch call.

Every name starts with "sf.":

  caller's thread  sf.setup        a Core's construction (the file's
                                   header, the reference's state and
                                   column maps on the device)
                   sf.read         a batch's records read from the file
                   sf.prep         submit_batch's host stages and the
                                   query batch's assembly
                   sf.sdtw_queue   the sDTW submit: the batch's upload and
                                   every launch queued; Core._span's
                                   sf.sdtw.<route> inside it
                   sf.drain_wait   waiting for the previous batch's drain
  pool workers     sf.decode       a pool chunk's decodes (~32 records)
                   sf.events       its pA conversion, events, polyA scan
                   sf.normalise    its query windows' z-scores (with
                                   profile=True the polyA scan too, as
                                   in Core.normalise_time)
  drain thread     sf.collect      waiting for the device's results
                   sf.backtrack    finish_batch's winner backtracks
                   sf.format       winner selection and PAF/SAM lines
                   sf.output       the lines written

A batch's spans are joined by containment: a worker's lie inside its
batch's sf.prep, a drain thread's inside that batch's drain. The drain
of the last batch (and every drain with profile=True) runs on the
caller's thread. A pool stage is a span a chunk, not a read: a range
costs ~13 us of host time, about what a read's z-score takes. With
--host-stages device the batch's events are one sf.events on the
caller's thread.

profile_all_threads() is the profiler option that records the ranges
opened on pool and drain threads too; without it only the thread that
started the profiler reaches the trace.

totals() are the process's, not a Core's: the benchmark's span readers
(benchmark/metrics/*_ms_per_read.py) see no Core, and a profiler that
records covers every Core of its window.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
# name -> [host seconds, count] of the spans closed while a profiler
# recorded, each timed inside its record_function range
_totals: dict[str, list] = {}


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        with _lock:
            t = _totals.setdefault(self.name, [0.0, 0])
            t[0] += dt
            t[1] += 1


def span(name: str):
    """A record_function range named `name` while a torch.profiler
    records (its host seconds summed into totals()); else a no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def totals() -> dict[str, tuple[float, int]]:
    """Each span name's summed host seconds and count over the spans
    closed while a profiler recorded, in this process."""
    with _lock:
        return {k: (v[0], v[1]) for k, v in _totals.items()}


def reset() -> None:
    """Clear totals()."""
    with _lock:
        _totals.clear()


def profile_all_threads():
    """torch.profiler.profile's experimental_config that records the
    ranges of every thread, not only of the one that starts it."""
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
