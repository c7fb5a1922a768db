"""decode_thread_ms_per_read (program span): the host milliseconds of the
sf.decode spans: each record's decode (pipeline._parse_single,
io/blow5.py, native/), summed over the pool's threads, waits for the
interpreter lock and for a CPU included, in run.py's traced window (the
overlapped schedule the end-to-end runs have, not the drained profile
window), per record of that window. The mapper sums its spans while a
profiler records (runtime/trace.py); this file is loaded before the
window opens, so BASE leaves out what came before it."""

from benchmark import spans

BASE = spans.snapshot()


def read(ctx):
    return spans.ms_per_read(ctx, ("sf.decode",), BASE)
