"""Seconds of video of every file whose run() ended inside the window,
over the time from the window's start to the last such end."""


def read(run):
    files = run.counted()
    if not files:
        return None
    last = max(f.end_ns for f in files)
    return run.video_s(files) / ((last - run.t0_ns) / 1e9)
