"""The program's own spans in a traced run (``mvtrim_tpu_torch.utils.timing``).

A batch that starts under an active ``torch.profiler`` session, as the
traced window's does, records the program's spans and keeps them when it
ends (``timing.follow_profiler``).  ``spans(run)`` drains them once, after
the window, and keeps them on the run as ``run.program_spans``; an
untraced run, or a program without that recorder, gives None, and so
every reader of them finds nothing to read.

Each span: name, start and end on ``time.time_ns`` (the device trace's
clock), the thread's CPU nanoseconds over it, the thread's name,
``parent`` (the index in ``spans(run)`` of the enclosing span on that
thread, or -1), the file id, the value and the kernel launches the thread
made inside it.
"""

from __future__ import annotations

from typing import NamedTuple

from . import trace


class ProgramSpan(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    cpu_ns: int
    thread: str
    parent: int
    file: int
    value: int
    launches: int


def _drain() -> list[ProgramSpan] | None:
    try:
        from mvtrim_tpu_torch.utils import timing
    except ImportError:
        return None
    stop = getattr(timing, "stop_recording", None)
    if stop is None:
        return None
    spans = [ProgramSpan(s.name, s.start_ns, s.end_ns, s.cpu_ns, s.thread,
                         s.parent, s.file, s.value, s.launches)
             for s in stop()]
    return spans or None


def spans(run) -> list[ProgramSpan] | None:
    """Every span the program kept in the traced run, or None."""
    if not hasattr(run, "program_spans"):
        run.program_spans = _drain() if run.ops is not None else None
    return run.program_spans


def window(run, name: str) -> list[ProgramSpan]:
    """The program's spans of one name that began inside the window."""
    return [s for s in spans(run) or ()
            if s.name == name and run.t0_ns <= s.start_ns <= run.t1_ns]


def durations(run, name: str) -> list[int]:
    return [s.end_ns - s.start_ns for s in window(run, name)]


def leaves(run) -> list[ProgramSpan]:
    """The spans no other span has as its parent (the innermost)."""
    every = spans(run) or []
    parents = {s.parent for s in every}
    return [s for i, s in enumerate(every) if i not in parents]


def idle_gaps(run, count: int = 10) -> list[list] | None:
    """The ``count`` longest idle gaps of the card in the window, each
    named by the innermost program span kind that overlaps it most (as
    ``idle_gaps`` names them by the benchmark's spans)."""
    if run.ops is None or spans(run) is None:
        return None
    inner = [(s.name, s.start_ns, s.end_ns, s.value) for s in leaves(run)
             if s.end_ns > run.t0_ns and s.start_ns < run.t1_ns]
    gaps = trace.idle_gaps(run.ops, run.t0_ns, run.t1_ns)
    return [["no program span" if label == "no benchmark span" else label,
             seconds]
            for label, seconds in trace.label_gaps(gaps, inner, count)]
