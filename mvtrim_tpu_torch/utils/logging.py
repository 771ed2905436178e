"""Colored, immediately-flushed logging (reference logging.hpp:49-91).

The reference serializes colored fmt::print calls behind a mutex and flushes
every line so Docker logs stream in real time.  Python's GIL serializes for
us; we keep the same levels, colors and [Stream N] prefix convention.
Set MVT_LOG=0 to silence (reference compiles logging out via ENABLE_LOGGING).
"""

from __future__ import annotations

import os
import sys
import threading

_lock = threading.Lock()
_enabled = os.environ.get("MVT_LOG", "1") != "0"
_color = sys.stdout.isatty() and os.environ.get("NO_COLOR") is None

_STYLES = {
    "INFO": "\x1b[37m",      # white
    "WARN": "\x1b[33m",      # yellow
    "ERROR": "\x1b[31m",     # red
    "PHASE": "\x1b[36m",     # cyan
    "SUCCESS": "\x1b[32m",   # green
}
_RESET = "\x1b[0m"


def _emit(level: str, msg: str, stream_id: int = -1) -> None:
    if not _enabled:
        return
    prefix = f"[Stream {stream_id}] " if stream_id >= 0 else ""
    line = f"[{level}] {prefix}{msg}"
    if _color:
        line = f"{_STYLES[level]}{line}{_RESET}"
    with _lock:
        print(line, flush=True)


def info(msg: str, stream_id: int = -1) -> None:
    _emit("INFO", msg, stream_id)


def warn(msg: str, stream_id: int = -1) -> None:
    _emit("WARN", msg, stream_id)


def error(msg: str, stream_id: int = -1) -> None:
    _emit("ERROR", msg, stream_id)


def phase(msg: str, stream_id: int = -1) -> None:
    _emit("PHASE", msg, stream_id)


def success(msg: str, stream_id: int = -1) -> None:
    _emit("SUCCESS", msg, stream_id)


def format_time(seconds: float) -> str:
    """HH:MM:SS (reference system.cpp:229-240)."""
    total = int(seconds)
    h, rem = divmod(total, 3600)
    m, s = divmod(rem, 60)
    return f"{h:02d}:{m:02d}:{s:02d}"


def print_cut_summary(duration: float, time_removed: float,
                      saved_pct: float, stream_id: int = -1) -> None:
    """The end-of-run cut summary block (reference pipeline.cpp:419-448)."""
    prefix = f"[Stream {stream_id}] " if stream_id >= 0 else ""
    print()
    print(f"{prefix}=================== CUT SUMMARY ====================")
    print(f"{prefix}{'Original:':<20} {format_time(duration):>15}")
    print(f"{prefix}{'Output:':<20} {format_time(duration - time_removed):>15}")
    print(f"{prefix}{'Removed:':<20} {format_time(time_removed):>15}")
    print(f"{prefix}{'Saved:':<20} {int(saved_pct):>14}%")
    print(f"{prefix}====================================================",
          flush=True)
