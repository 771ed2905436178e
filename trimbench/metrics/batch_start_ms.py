"""Milliseconds from the window's start to the first file's run(): the
batch layer enqueuing the backlog and starting its stream workers, a
stall inside the window, timed by the benchmark's own wrapper."""


def read(run):
    starts = [f.start_ns for f in run.files if f.start_ns >= run.t0_ns]
    return (min(starts) - run.t0_ns) / 1e6 if starts else None
