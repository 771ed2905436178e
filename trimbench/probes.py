"""The benchmark's own probes around the program's calls.

Always on: ``ProcessingPipeline.run`` is timed per file (the completions
and walls the end-to-end metrics read), and each ``_parallel_scan``'s
result is kept (the frames scanned and the motion timestamps the check
compares).  With tracing, host spans are kept too, on the same clock as
the profiler's trace (``time.time_ns``): ``dispatch:<payload>`` around
each ``scan_*_async`` of the MV detector (value: frames) and ``resolve``
around its resolver, ``scan_luma`` around the SAD detector's call (value:
frame comparisons), ``segmentation`` around the merge, the segmentation
and the cut decision, ``cut_handoff`` around ``CutQueue.push`` and
``cut`` around each cut the cut worker runs (up to the remux stand-in).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import time

import numpy as np


@dataclasses.dataclass
class FileRecord:
    path: str
    start_ns: int
    end_ns: int = 0
    rc: int | None = None
    error: str = ""
    # (kind, frames scanned, frames with MVs, motion timestamps) a scan
    passes: list = dataclasses.field(default_factory=list)


class Recorder:
    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.files: list[FileRecord] = []
        self.spans: list[tuple[str, int, int, int]] = []
        self._lock = threading.Lock()

    def span(self, kind: str, t0: int, t1: int, value: int = 0) -> None:
        self.spans.append((kind, t0, t1, value))

    def done(self, record: FileRecord) -> None:
        with self._lock:
            self.files.append(record)


def _timed(recorder: Recorder, kind: str, fn, value=lambda *a, **k: 0):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.time_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            recorder.span(kind, t0, time.time_ns(), value(*args, **kwargs))
    return wrapper


def _dispatch(recorder: Recorder, payload: str, fn):
    @functools.wraps(fn)
    def wrapper(self, data, *rest):
        t0 = time.time_ns()
        resolver = fn(self, data, *rest)
        recorder.span(f"dispatch:{payload}", t0, time.time_ns(),
                      int(data.shape[0]))
        return _timed(recorder, "resolve", resolver)
    return wrapper


def _comparisons(self, luma, carry=None) -> int:
    return max(0, luma.shape[0] + (carry is not None) - 1)


def install(recorder: Recorder):
    """Patch the probes in; returns the undo."""
    from mvtrim_tpu_torch.core import oracle
    from mvtrim_tpu_torch.cut import executor
    from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
    from mvtrim_tpu_torch.models.sad_detector import SADDetector
    from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline

    saved = []

    def patch(owner, name, new):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    run, scan = ProcessingPipeline.run, ProcessingPipeline._parallel_scan

    def timed_run(self):
        record = FileRecord(self.input_path, time.time_ns())
        self._trimbench_record = record
        try:
            record.rc = run(self)
            return record.rc
        except BaseException as e:
            record.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            record.end_ns = time.time_ns()
            recorder.done(record)

    def kept_scan(self, kind, fps, width, height):
        result = scan(self, kind, fps, width, height)
        self._trimbench_record.passes.append(
            (kind, result.frames_scanned, result.frames_with_mvs,
             np.asarray(result.motion_ts, np.float64)))
        return result

    patch(ProcessingPipeline, "run", timed_run)
    patch(ProcessingPipeline, "_parallel_scan", kept_scan)
    if recorder.tracing:
        for payload, name in (("bits", "scan_bits_async"),
                              ("words", "scan_words_async"),
                              ("grids", "scan_votes_async"),
                              ("mv_raw", "scan_raw_mvs_async")):
            patch(MVClusterDetector, name, _dispatch(
                recorder, payload, getattr(MVClusterDetector, name)))
        patch(SADDetector, "scan_luma", _timed(
            recorder, "scan_luma", SADDetector.scan_luma, _comparisons))
        for name in ("merge_timestamps", "segments_from_timestamps",
                     "decide_cut"):
            patch(oracle, name, _timed(recorder, "segmentation",
                                       getattr(oracle, name)))
        patch(executor.CutQueue, "push", _timed(
            recorder, "cut_handoff", executor.CutQueue.push))
        patch(executor, "execute_cut", _timed(
            recorder, "cut", executor.execute_cut))

    def undo() -> None:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)

    return undo
