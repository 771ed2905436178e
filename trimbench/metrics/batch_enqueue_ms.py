"""Milliseconds of the batch's enqueue of its backlog: the program's
``batch.enqueue`` span (``BatchProcessor.process`` checking each output
and filling the work queue) that began in the window."""

from trimbench import program


def read(run):
    spans = program.durations(run, "batch.enqueue")
    return sum(spans) / 1e6 if spans else None
