"""Leveled, colored stderr logging.

ref: sigfish src/error.h:22-84 (7 levels, ANSI colored macros, default
LOG_VERB) -- same numeric levels so `--verbose INT` behaves identically.
"""

import sys

LOG_OFF = 0   # nothing at all
LOG_ERR = 1   # error messages
LOG_WARN = 2  # warning and error messages
LOG_INFO = 3  # information, warning and error messages
LOG_VERB = 4  # verbose, information, warning and error messages
LOG_DBUG = 5  # debugging, verbose, ...
LOG_TRAC = 6  # tracing, debugging, ...

_log_level = LOG_VERB

_RED = "\033[31m"
_YELLOW = "\033[33m"
_CYAN = "\033[36m"
_RESET = "\033[0m"


def set_log_level(level: int) -> None:
    global _log_level
    _log_level = int(level)


def get_log_level() -> int:
    return _log_level


def _emit(prefix: str, color: str, msg: str) -> None:
    use_color = sys.stderr.isatty()
    if use_color:
        sys.stderr.write(f"{color}[{prefix}]{_RESET} {msg}\n")
    else:
        sys.stderr.write(f"[{prefix}] {msg}\n")


def log_error(msg: str) -> None:
    if _log_level >= LOG_ERR:
        _emit("ERROR", _RED, msg)


def log_warning(msg: str) -> None:
    if _log_level >= LOG_WARN:
        _emit("WARNING", _YELLOW, msg)


def log_info(msg: str) -> None:
    if _log_level >= LOG_INFO:
        _emit("INFO", _CYAN, msg)


def log_verbose(msg: str) -> None:
    if _log_level >= LOG_VERB:
        sys.stderr.write(f"[INFO] {msg}\n")


def log_debug(msg: str) -> None:
    if _log_level >= LOG_DBUG:
        _emit("DEBUG", _CYAN, msg)


def log_trace(msg: str) -> None:
    if _log_level >= LOG_TRAC:
        _emit("TRACE", _CYAN, msg)
