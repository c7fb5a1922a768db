"""sdtw_queue_ms_per_read (program span): the host milliseconds of the
sf.sdtw_queue spans: the sDTW submit (the batch's upload and every
launch of its route queued: the chunked route's carry chain and its
folds' torch ops), on the thread that runs the batch loop, in run.py's
traced window (the overlapped schedule the end-to-end runs have, not the
drained profile window), per record of that window. The mapper sums its
spans while a profiler records (runtime/trace.py); this file is loaded
before the window opens, so BASE leaves out what came before it."""

from benchmark import spans

BASE = spans.snapshot()


def read(ctx):
    return spans.ms_per_read(ctx, ("sf.sdtw_queue",), BASE)
