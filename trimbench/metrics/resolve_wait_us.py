"""Mean microseconds the resolver waited on one device batch's event:
the program's ``detector.wait`` spans that began in the window."""

from trimbench import program


def read(run):
    spans = program.durations(run, "detector.wait")
    return sum(spans) / len(spans) / 1e3 if spans else None
