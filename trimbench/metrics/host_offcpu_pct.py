"""The share of wall time the program's threads spent off a core inside
the spans that work on it (no span that waits by design): Σ (wall − the
thread's CPU time) over Σ wall of the spans below that began in the
window, all threads.  Off a core there is waiting for the GIL, or
preemption: a bound on the GIL wait, not the wait itself."""

from trimbench import program

WORKING = ("pipeline.probe", "scan.decode", "detector.stage",
           "detector.enqueue", "pipeline.segment", "cut.run")


def read(run):
    spans = [s for name in WORKING for s in program.window(run, name)]
    wall = sum(s.end_ns - s.start_ns for s in spans)
    if not wall:
        return None
    return 100.0 * (wall - sum(s.cpu_ns for s in spans)) / wall
