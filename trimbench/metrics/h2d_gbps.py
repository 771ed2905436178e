"""Bytes copied host to card over the card's time copying them, from the
profiler's Memcpy HtoD operations in the window."""


def read(run):
    ops = [op for op in run.ops or () if op.kind == "memcpy_htod"]
    nbytes = sum(op.nbytes for op in ops)
    busy = sum(op.end_ns - op.start_ns for op in ops)
    return nbytes / busy if nbytes and busy else None
