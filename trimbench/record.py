"""What one run leaves for the metric readers (``metrics/<name>.py``).

Times are ``time.time_ns`` (the clock of the profiler's trace); the
window is ``[t0_ns, t1_ns]``.  ``files`` holds every file whose
``run()`` ended, in the window or after it (the files in flight when the
window closed); ``counted()`` those that ended inside it, successfully,
which the end-to-end metrics count.  ``phases`` is the program's own
``MVT_METRICS_JSON`` line of each file, by input path.  ``spans`` (the
benchmark's host spans, see ``probes``) and ``ops`` (the card's
operations inside the window, see ``trace``) are there in a traced run
only.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Run:
    geom: object
    t0_ns: int
    t1_ns: int
    setup_s: float
    setup_parts: dict
    cpu_s: float
    files: list
    specs: dict
    phases: dict
    spans: list | None = None
    ops: list | None = None

    def counted(self) -> list:
        return [f for f in self.files
                if f.end_ns <= self.t1_ns and f.rc == 0 and not f.error]

    def video_s(self, files=None) -> float:
        files = self.counted() if files is None else files
        return sum(self.specs[f.path].duration for f in files)

    def window_spans(self, kind: str) -> list:
        """Spans of a kind (``dispatch:`` matches every payload) that
        began inside the window."""
        return [s for s in self.spans or ()
                if (s[0] == kind or (kind.endswith(":")
                                     and s[0].startswith(kind)))
                and self.t0_ns <= s[1] <= self.t1_ns]

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9
