"""The process's user and system CPU seconds over the window (all
threads), per hour of video completed in it."""


def read(run):
    video_h = run.video_s() / 3600.0
    return run.cpu_s / video_h if video_h > 0 else None
