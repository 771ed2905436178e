"""Mean host microseconds of one MV detector call: each scan_*_async
with its resolver, from the benchmark's spans of the window.  In the
SAD cells these are the auto pipeline's MV pre-pass; the luma scan's own
calls are scan_luma_host_ms."""


def read(run):
    calls = run.window_spans("dispatch:")
    if not calls:
        return None
    resolves = run.window_spans("resolve")
    total = sum(s[2] - s[1] for s in calls + resolves)
    return total / len(calls) / 1e3
