"""K1 (csrc/word_cluster.cu) against the card's HBM roofline: the least
time of every frame dispatched to it in the window (bytes by
roofline.k1_bytes_per_frame) over its device time in the trace."""

from trimbench import roofline

KERNEL = "word_cluster_kernel"


def read(run):
    busy = sum(op.end_ns - op.start_ns for op in run.ops or ()
               if op.kind == "kernel" and KERNEL in op.name)
    frames = sum(s[3] for s in run.window_spans("dispatch:")
                 if s[0] in ("dispatch:bits", "dispatch:words"))
    if not busy or not frames:
        return None
    least = roofline.least_s(frames * roofline.k1_bytes_per_frame(run.geom),
                             frames * roofline.k1_ops_per_frame(run.geom))
    return 100.0 * least / (busy / 1e9)
