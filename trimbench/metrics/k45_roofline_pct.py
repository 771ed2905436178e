"""K4+K5 (csrc/mv_cluster.cu) against the card's roofline: the least time
(``roofline_mv.k45_least_s``) of the files' raw-MV batches that began in
the window, outside ``scan.warmup`` (the live rows: the program's
``detector.mv_rows`` values; the frames: its ``detector.enqueue`` values),
over the device time of ``mv_cluster_kernel`` in the trace.  None where
the program records no live rows (no ``detector.mv_rows``) or the card
ran no such kernel."""

from trimbench import program, roofline_mv

KERNEL = "mv_cluster_kernel"


def outside_warmup(run, name: str) -> list:
    """The program's spans of one name that began in the window and lie
    under no ``scan.warmup`` span."""
    every = program.spans(run) or []
    out = []
    for s in program.window(run, name):
        parent = s.parent
        while parent >= 0 and every[parent].name != "scan.warmup":
            parent = every[parent].parent
        if parent < 0:
            out.append(s)
    return out


def read(run):
    busy = sum(op.end_ns - op.start_ns for op in run.ops or ()
               if op.kind == "kernel" and KERNEL in op.name)
    rows = outside_warmup(run, "detector.mv_rows")
    frames = sum(s.value for s in outside_warmup(run, "detector.enqueue"))
    if not busy or not rows or not frames:
        return None
    least = roofline_mv.k45_least_s(sum(s.value for s in rows), frames,
                                    run.geom)
    return 100.0 * least / (busy / 1e9)
