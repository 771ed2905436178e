"""Phase timing (reference logging.hpp:109-148, logging.cpp:27-55) and
the program's spans.

A process-global, thread-safe collector of named microsecond measurements
plus a context-manager timer.  Printed as the same end-of-run table the
reference emits; tree indentation is the caller's business (names may embed
the reference's box-drawing prefixes).

``SPANS`` records spans at the program's layer boundaries: a name, start
and end on ``time.time_ns()`` (the clock a ``torch.profiler`` trace's
``baseTimeNanoseconds`` follows), the thread's CPU time over the span,
the thread, the enclosing span on that thread, the file (one id per
``ProcessingPipeline.run``, shared by its decode workers and the cut
worker), one integer value, and the kernel launches the thread made inside
the span.  Recording is off unless ``start_recording()`` (or
``MVT_PROFILE_DIR``) turns it on; ``stop_recording()`` stops it and
returns what was kept.  Off, a site costs one attribute check::

    span = SPANS.begin("detector.stage") if SPANS.on else None
    ...
    if span is not None:
        SPANS.end(span, nbytes)

On, rows of integers go to a buffer of the calling thread (names interned
to small ids), which the garbage collector does not track.
"""

from __future__ import annotations

import array
import contextlib
import itertools
import sys
import threading
import time
from typing import NamedTuple


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


class Span(NamedTuple):
    """One recorded span.  ``parent`` is the index of the enclosing span
    in the list ``stop_recording`` returns (-1 at a thread's top level);
    ``tid`` is the thread's native id, ``thread`` its name."""

    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int
    tid: int
    thread: str
    parent: int
    file: int
    value: int
    launches: int


# a row of a thread's buffer
_NAME, _START, _END, _CPU, _PARENT, _FILE, _VALUE, _LAUNCHES = range(8)
_NCOL = 8
_ROW_BITS = 40
_ROW_MASK = (1 << _ROW_BITS) - 1


class _Thread:
    __slots__ = ("gen", "buf", "stack", "file", "launches")


class SpanRecorder:
    """Spans in per-thread buffers, kept in memory until drained.

    A token from ``begin`` carries the recording's generation, so a span
    still open when recording stops and starts again is dropped, not
    written into the next recording's rows.  Spans on one thread nest:
    ``end`` closes its span and any left open inside it.
    """

    def __init__(self):
        self.on = False
        self._gen = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids: dict[str, int] = {}
        self._names: list[str] = []
        self._bufs: list[array.array] = []
        self._threads: list[str] = []
        self._tids = array.array("q")
        self._files = itertools.count(1)

    # --- the switch ---

    def start(self) -> bool:
        """Turn recording on with empty buffers; False where it was on
        already (its owner drains it)."""
        with self._lock:
            if self.on:
                return False
            self._drop()
            self.on = True
            return True

    def pause(self) -> None:
        """Stop taking new spans; what was kept stays until drained."""
        self.on = False

    def stop(self) -> list[Span]:
        """Stop recording and drain it: every span that ended, by thread
        and then in the order they began."""
        with self._lock:
            self.on = False
            spans = self._spans()
            self._drop()
            return spans

    def recorded(self) -> list[Span]:
        """The spans that ended so far, recording left as it is."""
        with self._lock:
            return self._spans()

    def _drop(self) -> None:
        self._gen += 1
        self._bufs, self._threads = [], []
        self._tids = array.array("q")

    # --- the sites ---

    def _thread(self) -> _Thread:
        st = getattr(self._tls, "state", None)
        if st is None:
            st = self._tls.state = _Thread()
            st.gen, st.file, st.launches = -1, 0, 0
        if st.gen != self._gen:
            st.buf, st.stack, st.file = array.array("q"), [], 0
            with self._lock:
                st.gen = self._gen
                self._bufs.append(st.buf)
                self._threads.append(threading.current_thread().name)
                self._tids.append(threading.get_native_id())
        return st

    def _intern(self, name: str) -> int:
        name_id = self._ids.get(name)
        if name_id is not None:
            return name_id
        with self._lock:
            name_id = self._ids.setdefault(name, len(self._names))
            if name_id == len(self._names):
                self._names.append(name)
        return name_id

    def begin(self, name: str, file: int | None = None) -> int:
        """Open a span on the calling thread; returns its token.  ``file``
        sets the thread's file id (a decode or cut worker takes the one of
        the file it works for)."""
        st = getattr(self._tls, "state", None)
        if st is None or st.gen != self._gen:
            st = self._thread()
        if file is not None:
            st.file = file
        name_id = self._ids.get(name)
        if name_id is None:
            name_id = self._intern(name)
        buf, stack = st.buf, st.stack
        row = len(buf)
        buf.extend((name_id, time.time_ns(), 0, time.thread_time_ns(),
                    stack[-1] if stack else -1, st.file, 0, st.launches))
        stack.append(row)
        return (st.gen << _ROW_BITS) | row

    def end(self, token: int, value: int = 0) -> None:
        # the CPU clock is read inside the wall clock's reads at both ends,
        # so a span's CPU time never exceeds its wall time
        cpu = time.thread_time_ns()
        end = time.time_ns()
        st = getattr(self._tls, "state", None)
        if st is None or token >> _ROW_BITS != st.gen or st.gen != self._gen:
            return
        row, buf, stack = token & _ROW_MASK, st.buf, st.stack
        if stack and stack[-1] == row:
            stack.pop()
        elif row in stack:
            del stack[stack.index(row):]
        else:
            return
        buf[row + _CPU] = cpu - buf[row + _CPU]
        buf[row + _VALUE] = int(value)
        buf[row + _LAUNCHES] = st.launches - buf[row + _LAUNCHES]
        buf[row + _END] = end  # last: a row with an end is whole

    def add(self, name: str, start_ns: int, value: int = 0,
            file: int | None = None) -> None:
        """A span that began on another thread (a job's wait in a queue)
        and ends now on this one; it carries no CPU time and no launches."""
        st = self._thread()
        if file is not None:
            st.file = file
        stack = st.stack
        st.buf.extend((self._intern(name), start_ns, time.time_ns(), 0,
                       stack[-1] if stack else -1, st.file, int(value), 0))

    def new_file(self) -> int:
        """A fresh file id for the calling thread's spans."""
        fid = next(self._files)
        self._thread().file = fid
        return fid

    def file(self) -> int:
        return self._thread().file

    def count_launch(self) -> None:
        """One kernel launch by the calling thread."""
        self._thread().launches += 1

    # --- the drain ---

    def _spans(self) -> list[Span]:
        names = self._names
        out: list[Span] = []
        for buf, thread, tid in zip(self._bufs, self._threads, self._tids):
            rows = buf.tolist()
            index = {}
            for row in range(0, len(rows) - len(rows) % _NCOL, _NCOL):
                r = rows[row:row + _NCOL]
                if r[_END] == 0:
                    continue  # still open
                index[row] = len(out)
                out.append(Span(names[r[_NAME]], r[_START], r[_END], r[_CPU],
                                tid, thread, index.get(r[_PARENT], -1),
                                r[_FILE], r[_VALUE], r[_LAUNCHES]))
        return out


SPANS = SpanRecorder()


def start_recording() -> bool:
    """Turn the program's span recording on; False where it was on."""
    return SPANS.start()


def stop_recording() -> list[Span]:
    """Turn it off and return the spans kept since it was turned on."""
    return SPANS.stop()


def follow_profiler() -> bool:
    """Turn recording on where a ``torch.profiler`` session is active and
    recording is off, so that a caller tracing the card also gets the
    program's spans (it drains them with ``stop_recording``).  True where
    this call turned it on: the caller ``pause``s it when its work ends."""
    torch = sys.modules.get("torch")
    if torch is None or not getattr(torch.autograd.profiler,
                                    "_is_profiler_enabled", False):
        return False
    return SPANS.start()


def chrome_events(spans: list[Span], base_ns: int, pid: int) -> list[dict]:
    """The spans as Chrome trace events for a trace whose ``ts`` counts
    microseconds from ``base_ns`` (a ``torch.profiler`` export's
    ``baseTimeNanoseconds``): one complete event a span, on its thread's
    row, with its file, value, launches and CPU microseconds."""
    events, threads = [], {}
    for s in spans:
        threads.setdefault(s.tid, s.thread)
        events.append({
            "ph": "X", "cat": "mvtrim", "name": s.name, "pid": pid,
            "tid": s.tid, "ts": (s.start_ns - base_ns) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"file": s.file, "value": s.value,
                     "launches": s.launches, "cpu_us": s.cpu_ns / 1e3}})
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in threads.items()]
    return events


@contextlib.contextmanager
def timer(name: str, collector=TimingCollector, span: str | None = None):
    """Scoped timer — the TIMER_START/TIMER_END macro pair; ``span`` also
    records the program span of that name while recording is on."""
    start = time.perf_counter_ns()
    token = SPANS.begin(span) if span is not None and SPANS.on else None
    try:
        yield
    finally:
        if token is not None:
            SPANS.end(token)
        collector.record(name, (time.perf_counter_ns() - start) // 1000)
