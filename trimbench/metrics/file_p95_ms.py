"""The 95th percentile of the wall of each file's run() that ended in
the window, as the benchmark's own wrapper timed it."""

import numpy as np


def read(run):
    walls = [(f.end_ns - f.start_ns) / 1e6 for f in run.counted()]
    return float(np.percentile(walls, 95)) if walls else None
