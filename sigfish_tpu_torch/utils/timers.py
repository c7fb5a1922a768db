"""Wall/CPU/RSS timers for the run report.

ref: sigfish src/misc.h:30-54 (realtime/cputime/peakrss from minimap2).
"""

import resource
import sys
import time


def realtime() -> float:
    return time.time()


def cputime() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    c = resource.getrusage(resource.RUSAGE_CHILDREN)
    return r.ru_utime + r.ru_stime + c.ru_utime + c.ru_stime


def peakrss() -> int:
    r = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if sys.platform == "linux":
        return r * 1024
    return r
