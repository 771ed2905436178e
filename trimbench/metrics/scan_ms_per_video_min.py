"""The program's own parallel_scan[*] phases (MVT_METRICS_JSON
phases_us) of the files counted, in ms per minute of their video."""


def read(run):
    files = [f for f in run.counted() if f.path in run.phases]
    minutes = run.video_s(files) / 60.0
    if not minutes:
        return None
    us = sum(v for f in files
             for k, v in run.phases[f.path]["phases_us"].items()
             if k.startswith("parallel_scan["))
    return us / 1e3 / minutes
