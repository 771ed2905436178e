"""Mean microseconds of staging one device batch: the program's
``detector.stage`` spans (contiguous rows, pinned host memory) that began
in the window."""

from trimbench import program


def read(run):
    spans = program.durations(run, "detector.stage")
    return sum(spans) / len(spans) / 1e3 if spans else None
