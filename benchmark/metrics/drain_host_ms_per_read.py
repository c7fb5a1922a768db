"""drain_host_ms_per_read (program span): the host milliseconds of the
sf.backtrack, sf.format and sf.output spans: the drain's winner
backtracks, winner selection and PAF/SAM lines, and writes, summed over
the threads that drain (the drain thread; a pass's last batch on the
batch loop's), in run.py's traced window (the overlapped schedule the
end-to-end runs have, not the drained profile window), per record of
that window. The mapper sums its spans while a profiler records
(runtime/trace.py); this file is loaded before the window opens, so BASE
leaves out what came before it."""

from benchmark import spans

BASE = spans.snapshot()


def read(ctx):
    return spans.ms_per_read(ctx, ("sf.backtrack", "sf.format", "sf.output"), BASE)
