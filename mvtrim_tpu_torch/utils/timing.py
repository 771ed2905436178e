"""Phase timing (reference logging.hpp:109-148, logging.cpp:27-55).

A process-global, thread-safe collector of named microsecond measurements
plus a context-manager timer.  Printed as the same end-of-run table the
reference emits; tree indentation is the caller's business (names may embed
the reference's box-drawing prefixes).
"""

from __future__ import annotations

import contextlib
import threading
import time


class TimingCollector:
    """Thread-local by design: in batch mode each stream worker thread runs
    its own pipeline and clears between files (batch_processor.cpp:378); a
    process-global list would let one stream wipe another's in-flight
    entries."""

    _tls = threading.local()

    @classmethod
    def _list(cls) -> list:
        entries = getattr(cls._tls, "entries", None)
        if entries is None:
            entries = cls._tls.entries = []
        return entries

    @classmethod
    def record(cls, name: str, micros: int) -> None:
        cls._list().append((name, int(micros)))

    @classmethod
    def entries(cls) -> list[tuple[str, int]]:
        return list(cls._list())

    @classmethod
    def clear(cls) -> None:
        cls._list().clear()

    @classmethod
    def print_summary(cls) -> None:
        entries = cls.entries()
        if not entries:
            return
        print("\n================= TIMING SUMMARY =================")
        for name, us in entries:
            print(f"{name:<34} {us / 1e6:>12.3f}s")
        print("==================================================", flush=True)


@contextlib.contextmanager
def timer(name: str, collector=TimingCollector):
    """Scoped timer — the TIMER_START/TIMER_END macro pair."""
    start = time.perf_counter_ns()
    try:
        yield
    finally:
        collector.record(name, (time.perf_counter_ns() - start) // 1000)
