"""Mean host milliseconds of one SAD detector call (scan_luma, which
stages, copies, decides and resolves a sub-scan of luma), from the
benchmark's spans of the window."""


def read(run):
    calls = run.window_spans("scan_luma")
    if not calls:
        return None
    return sum(s[2] - s[1] for s in calls) / len(calls) / 1e6
