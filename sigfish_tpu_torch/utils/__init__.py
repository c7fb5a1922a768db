from .log import (
    set_log_level,
    get_log_level,
    log_error,
    log_warning,
    log_info,
    log_verbose,
    log_debug,
    log_trace,
    LOG_ERR,
    LOG_WARN,
    LOG_INFO,
    LOG_VERB,
    LOG_DBUG,
    LOG_TRAC,
)
from .timers import realtime, cputime, peakrss
