"""prep_ms_per_read (program span): the host milliseconds of the sf.prep
spans: submit_batch's decode, host stages and the query batch's
assembly, on the thread that runs the batch loop (the next batch's host
work while the device runs this one's), in run.py's traced window (the
overlapped schedule the end-to-end runs have, not the drained profile
window), per record of that window. The mapper sums its spans while a
profiler records (runtime/trace.py); this file is loaded before the
window opens, so BASE leaves out what came before it."""

from benchmark import spans

BASE = spans.snapshot()


def read(ctx):
    return spans.ms_per_read(ctx, ("sf.prep",), BASE)
