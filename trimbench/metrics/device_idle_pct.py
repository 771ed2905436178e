"""The share of the traced window in which no kernel, copy or memset ran
on the card (the union of the profiler's device intervals)."""

from trimbench import trace


def read(run):
    if run.ops is None:
        return None
    return 100.0 * (1.0 - trace.busy_ns(run.ops) / (run.t1_ns - run.t0_ns))
