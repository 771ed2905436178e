"""Frames of the files' chunks over every kernel launch the detector made
for them: the values of the program's ``detector.enqueue`` spans that
began in the window outside a ``scan.warmup`` span, over the launches
on all of those spans, the warm-up's launch of one zero frame included
(useful work over attempts)."""

from trimbench import program


def read(run):
    every = program.spans(run)
    spans = program.window(run, "detector.enqueue")
    launches = sum(s.launches for s in spans)
    if not launches:
        return None
    frames = sum(s.value for s in spans
                 if s.parent < 0 or every[s.parent].name != "scan.warmup")
    return frames / launches
