"""The decode the raw-MV payload throws away by overflow: 100 × the
frames of the program's ``scan.mv_restart`` spans (a capacity restart's
frames decoded in vain) over the frames of its ``scan.decode`` spans,
both begun in the window.  None where no ``scan.decode`` span began there,
or where the program's pipeline has no ``scan.mv_restart`` site (it read
0 there, as a run that never overflows does)."""

import importlib.util

from trimbench import program

SITE = "mvtrim_tpu_torch.pipeline.pipeline"


def has_site() -> bool:
    found = importlib.util.find_spec(SITE)
    if found is None or not found.origin:
        return False
    with open(found.origin) as f:
        return '"scan.mv_restart"' in f.read()


def read(run):
    decoded = sum(s.value for s in program.window(run, "scan.decode"))
    if not decoded or not has_site():
        return None
    vain = sum(s.value for s in program.window(run, "scan.mv_restart"))
    return 100.0 * vain / decoded
