"""Mean microseconds of enqueuing one device batch: the program's
``detector.enqueue`` spans (the H2D copy, the kernel's launch, the D2H
copy and the event) that began in the window."""

from trimbench import program


def read(run):
    spans = program.durations(run, "detector.enqueue")
    return sum(spans) / len(spans) / 1e3 if spans else None
