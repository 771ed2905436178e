"""The share of the raw-MV payload staged and copied to the card that the
rule reads: 100 × 8 bytes × the live rows (the program's
``detector.mv_rows`` values) over the bytes of the ``detector.stage``
spans that hold them, of the batches that began in the window.  None
where the program records no live rows (no ``detector.mv_rows``)."""

from trimbench import program


def read(run):
    every = program.spans(run) or []
    rows = program.window(run, "detector.mv_rows")
    staged = {s.parent for s in rows if s.parent >= 0}
    nbytes = sum(every[i].value for i in staged
                 if every[i].name == "detector.stage")
    if not rows or not nbytes:
        return None
    return 100.0 * 8 * sum(s.value for s in rows) / nbytes
