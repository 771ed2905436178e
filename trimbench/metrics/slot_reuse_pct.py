"""The share of device batches staged in a slot the program had pinned
before: 100 × (1 − the program's ``detector.pin`` spans over its
``detector.stage`` spans), of those that began in the window.  A program
that stages in no reused slots (no ``models/staging.py``), or a window in
which no ``detector.enqueue`` launched a kernel (the CPU build), gives
None."""

import importlib.util

from trimbench import program


def read(run):
    if importlib.util.find_spec("mvtrim_tpu_torch.models.staging") is None:
        return None
    if not any(s.launches for s in program.window(run, "detector.enqueue")):
        return None
    stages = len(program.window(run, "detector.stage"))
    if not stages:
        return None
    return 100.0 * (1 - len(program.window(run, "detector.pin")) / stages)
