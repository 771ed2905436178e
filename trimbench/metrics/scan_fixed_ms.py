"""Milliseconds a scan spends outside its decode and its dispatches: the
mean of the program's ``scan.warmup`` (the detector's build and its
synchronous launch of one zero frame), ``scan.setup`` (the chunk tasks)
and ``scan.join`` (the decode workers' join) spans that began in the
window, added."""

from trimbench import program

PARTS = ("scan.warmup", "scan.setup", "scan.join")


def read(run):
    total = 0.0
    for name in PARTS:
        spans = program.durations(run, name)
        if not spans:
            return None
        total += sum(spans) / len(spans)
    return total / 1e6
