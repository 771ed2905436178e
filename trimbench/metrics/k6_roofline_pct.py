"""K6 (csrc/sad_block.cu) against the card's HBM roofline: the least time
of its launches in the window (bytes by roofline.k6_bytes over the frame
comparisons the scan_luma spans asked for) over its device time."""

from trimbench import roofline

KERNEL = "sad_block_kernel"


def read(run):
    k6 = [op for op in run.ops or ()
          if op.kind == "kernel" and KERNEL in op.name
          and "resident" not in op.name]
    comparisons = sum(s[3] for s in run.window_spans("scan_luma"))
    if not k6 or not comparisons:
        return None
    busy = sum(op.end_ns - op.start_ns for op in k6) / 1e9
    least = roofline.least_s(
        roofline.k6_bytes(run.geom, comparisons, len(k6)),
        roofline.k6_ops(run.geom, comparisons))
    return 100.0 * least / busy
