"""Leveled logging (port of open3d_tpu/utils/logging.py; Open3D's
utility/Logging.h): log_error logs and raises RuntimeError, the other
levels print to stderr when the global verbosity admits them, and
`verbosity_context` overrides the verbosity for a block.
"""

from __future__ import annotations

import contextlib
import enum
import sys
import time


class VerbosityLevel(enum.IntEnum):
    ERROR = 0
    WARNING = 1
    INFO = 2
    DEBUG = 3


_LEVEL = VerbosityLevel.INFO


def set_verbosity_level(level: VerbosityLevel | int) -> None:
    global _LEVEL
    _LEVEL = VerbosityLevel(level)


def get_verbosity_level() -> VerbosityLevel:
    return _LEVEL


@contextlib.contextmanager
def verbosity_context(level: VerbosityLevel | int):
    prev = get_verbosity_level()
    set_verbosity_level(level)
    try:
        yield
    finally:
        set_verbosity_level(prev)


def _emit(tag: str, msg: str, *args, **kwargs) -> None:
    if args or kwargs:
        msg = msg.format(*args, **kwargs)
    ts = time.strftime("%H:%M:%S")
    print(f"[open3d_tpu {tag} {ts}] {msg}", file=sys.stderr, flush=True)


def log_error(msg: str, *args, **kwargs):
    """Log at ERROR and raise RuntimeError (Open3D's LogError throws)."""
    if args or kwargs:
        msg = msg.format(*args, **kwargs)
    _emit("ERROR", msg)
    raise RuntimeError(msg)


def log_warning(msg: str, *args, **kwargs) -> None:
    if _LEVEL >= VerbosityLevel.WARNING:
        _emit("WARN ", msg, *args, **kwargs)


def log_info(msg: str, *args, **kwargs) -> None:
    if _LEVEL >= VerbosityLevel.INFO:
        _emit("INFO ", msg, *args, **kwargs)


def log_debug(msg: str, *args, **kwargs) -> None:
    if _LEVEL >= VerbosityLevel.DEBUG:
        _emit("DEBUG", msg, *args, **kwargs)
