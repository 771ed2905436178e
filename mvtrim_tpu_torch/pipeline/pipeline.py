"""Single-video processing pipeline: the reference's per-video
orchestration (pipeline.cpp:89-415) on a host-decode / device-analyze
split.  Probe -> chunked parallel host decode (threads over a shared task
queue, a reader each; ctypes releases the GIL) -> each payload's parts
through the detector (``payloads``: bits, words, grids or mv_raw to
MVClusterDetector; the luma to SADDetector under MVT_PIPELINE=sad and
the auto fallback where no frame carries MV side data) -> motion
timestamps -> merge -> gap segmentation with padding -> savings decision
-> lossless cut (direct or via CutQueue).  Phase accounting mirrors the
reference's timing tree (pipeline.cpp:274-292).  The scan's spans:
"scan.warmup", "scan.setup", "scan.feeder_wait" and "scan.join" here;
"scan.decode", "scan.mv_carried", "scan.mv_restart" and
"scan.mv_capacity.<M>" in the payloads' chunk decode.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import queue
import threading
import time

import numpy as np

from ..core import oracle
from ..core.config import Config
from ..core.types import ScanTask
from ..cut.executor import CutJob, CutQueue, execute_cut
from ..io import native
from ..utils import logging as log
from ..utils import system
from ..utils.logging import format_time
from ..utils.timing import SPANS, TimingCollector, held_trace, timer
from . import payloads


@dataclasses.dataclass
class ScanResult:
    motion_ts: list[float]
    frames_scanned: int
    frames_with_mvs: int
    chunks: int


class ProcessingPipeline:
    """Process one video: scan for motion, cut out the static parts.

    When ``cut_queue`` is provided (batch mode) the cut job is pushed for
    deferred execution instead of running inline (pipeline.cpp:358-404);
    ``stream_id >= 0`` prefixes log lines; ``device`` pins this stream's
    analysis to one card.  ``open_reader(mode)`` opens each decode
    worker's reader (``native.VideoReader`` of the input; a stand-in with
    its scan methods drives the scan where no decoder is present).
    """

    def __init__(self, input_path: str, output_path: str,
                 stream_id: int = -1, num_threads: int = 0,
                 cfg: Config | None = None,
                 cut_queue: CutQueue | None = None,
                 device=None):
        self.input_path = input_path
        self.output_path = output_path
        self.stream_id = stream_id
        self.num_threads = num_threads
        self.cfg = cfg or Config.from_env()
        self.cut_queue = cut_queue
        self.device = device
        self.open_reader = functools.partial(native.VideoReader, input_path)
        self.duration = 0.0
        self.time_removed = 0.0
        self.saved_pct = 0.0

    # --- main entry ---

    def run(self) -> int:
        """Scan, decide and cut one file; 0 on success.  A single file
        (``stream_id < 0``) holds MVT_PROFILE_DIR's trace and takes a
        file id of its own; a batch's stream runs under the batch's."""
        if self.stream_id >= 0:
            return self._run()
        with held_trace(self.cfg.profile_dir):
            if SPANS.on:
                SPANS.new_file()
            return self._run()

    def _run(self) -> int:
        sid = self.stream_id
        t_total = time.perf_counter_ns()

        log.phase("Mapping + probing...", sid)
        try:
            with timer("probe", span="pipeline.probe"):
                probe = native.VideoReader(self.input_path)
                self.duration = probe.duration
                fps = probe.fps
                width, height = probe.width, probe.height
                probe.close()
        except OSError as e:
            log.error(f"Failed to open {self.input_path}: {e}", sid)
            return 1

        log.info(
            f"Duration: {format_time(self.duration)} "
            f"({self.duration * fps:.0f} frames @ {fps:.1f}fps)", sid)

        mode = self.cfg.pipeline_mode
        if mode not in ("mv", "sad", "auto"):
            # a typo ("SAD", "sda") would otherwise select the MV scan
            # WITHOUT the auto-SAD fallback (payloads.choose guards likewise)
            log.warn(f"Unknown MVT_PIPELINE={mode!r}; using auto", sid)
            mode = "auto"
        try:
            if mode == "sad":
                result = self._parallel_scan("sad", fps, width, height)
            else:
                result = self._parallel_scan("mv", fps, width, height)
                if (mode == "auto" and not result.motion_ts
                        and result.frames_scanned > 0
                        and result.frames_with_mvs == 0):
                    log.warn("No MV side data in any frame — "
                             "falling back to pixel-domain SAD scan", sid)
                    result = self._parallel_scan("sad", fps, width, height)
        except RuntimeError as e:
            log.error(f"Scan failed: {e}", sid)
            return 1

        log.info(f"Processed {result.chunks} chunks, scanned "
                 f"{result.frames_scanned} frames, found "
                 f"{len(result.motion_ts)} motion frames", sid)

        # --- merge + dedupe (pipeline.cpp:302-304) ---
        log.phase("Merging...", sid)
        segment_span = SPANS.begin("pipeline.segment") if SPANS.on else None
        with timer("merge"):
            timestamps = oracle.merge_timestamps(result.motion_ts)

        if timestamps.size == 0:
            if segment_span is not None:
                SPANS.end(segment_span)
            log.warn("No motion found.", sid)
            return self._finish(result, 0, None, t_total)

        # --- segmentation (pipeline.cpp:321-356) ---
        with timer("segmentation"):
            segments = oracle.segments_from_timestamps(
                timestamps, max_gap_sec=self.cfg.max_gap_sec,
                padding_sec=self.cfg.padding_sec, duration=self.duration)

        self.time_removed, self.saved_pct = oracle.savings(
            segments, self.duration)

        # --- cut-vs-copy decision (pipeline.cpp:358-404) ---
        is_cut, out_segments = oracle.decide_cut(
            segments, self.duration, self.cfg.min_savings_pct)
        if segment_span is not None:
            SPANS.end(segment_span, timestamps.size)
        if not is_cut:
            log.warn(
                f"Savings too low ({int(self.saved_pct)}%). Min required: "
                f"{int(self.cfg.min_savings_pct)}%. Copying full stream.",
                sid)

        if self.cut_queue is not None:
            self.cut_queue.push(CutJob(
                stream_id=sid,
                input_path=os.path.abspath(self.input_path),
                output_path=self.output_path,
                segments=out_segments))
            log.info("Pushed cut job to queue", sid)
        else:
            log.phase("Cutting...", sid)
            with timer("execute_cut"):
                execute_cut(self.input_path, self.output_path, out_segments,
                            sid, self.cfg)

        return self._finish(result, int(timestamps.size), is_cut, t_total)

    def _finish(self, result: ScanResult, motion_frames: int,
                is_cut: bool | None, t_total: int) -> int:
        """Record the total, print a single file's timing table and a
        decided run's cut summary, and append the per-video metrics
        (MVT_METRICS_JSON, JSON lines; the reference has none); 0."""
        TimingCollector.record(
            "total_run", (time.perf_counter_ns() - t_total) // 1000)
        if self.stream_id < 0:
            TimingCollector.print_summary()
        if is_cut is not None:
            self.print_cut_summary()
        if not self.cfg.metrics_json:
            return 0
        phases: dict[str, int] = {}
        for name, us in TimingCollector.entries():
            phases[name] = phases.get(name, 0) + us
        rec = {
            "input": self.input_path,
            "output": self.output_path,
            "stream_id": self.stream_id,
            "duration_sec": self.duration,
            "frames_scanned": result.frames_scanned,
            "frames_with_mvs": result.frames_with_mvs,
            "motion_frames": motion_frames,
            "time_removed_sec": self.time_removed,
            "saved_pct": self.saved_pct,
            "decision": ("cut" if is_cut else
                         "copy" if is_cut is not None else "no_motion"),
            "wall_sec": (time.perf_counter_ns() - t_total) / 1e9,
            "phases_us": phases,
        }
        try:
            with open(self.cfg.metrics_json, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as e:
            log.warn(f"metrics export failed: {e}", self.stream_id)
        return 0

    # --- scan phase (pipeline.cpp:127-295) ---

    def _scan_thread_count(self, num_chunks: int) -> int:
        """Thread count rules (pipeline.cpp:129-143): explicit per-stream
        count in batch mode, else max(2, cgroup-aware cpu limit), always
        capped by the chunk count."""
        n = (self.cfg.decode_workers if self.cfg.decode_workers > 0
             else self.num_threads if self.num_threads > 0
             else max(2, system.detect_cpu_limit()))
        return max(1, min(n, num_chunks))

    def _parallel_scan(self, kind: str, fps: float, width: int,
                       height: int) -> ScanResult:
        """Chunked parallel decode + batched device analysis of ``kind``
        'mv' (an MV payload -> cluster kernels) or 'sad' (luma -> block SAD
        and cluster-map kernels); the payload decodes and dispatches."""
        sid, cfg = self.stream_id, self.cfg
        num_chunks = max(1, math.ceil(self.duration /
                                      cfg.chunk_duration_sec))
        n_threads = self._scan_thread_count(num_chunks)
        payload = payloads.choose(kind, cfg, sid)(
            cfg, width, height, fps, n_threads, device=self.device)
        log.phase(f"{payload.label} ({n_threads} threads, "
                  f"{cfg.chunk_duration_sec:.0f}s chunks)...", sid)
        t_scan = time.perf_counter_ns()

        # Warm the device path BEFORE spawning decode threads: the first
        # call builds the CUDA kernels (nvcc, once per source set) and makes
        # the first launch, host-CPU work that would contend with the
        # decoders
        span = SPANS.begin("scan.warmup") if SPANS.on else None
        warm_t0 = time.perf_counter_ns()
        payload.warm_up()
        warmup_us = (time.perf_counter_ns() - warm_t0) // 1000
        if span is not None:
            SPANS.end(span)

        span = SPANS.begin("scan.setup") if SPANS.on else None
        setup_t0 = time.perf_counter_ns()
        tasks: queue.Queue[ScanTask | None] = queue.Queue()
        chunk_id, t = 0, 0.0
        while t < self.duration:
            tasks.put(ScanTask(t, min(t + cfg.chunk_duration_sec,
                                      self.duration), chunk_id))
            chunk_id, t = chunk_id + 1, t + cfg.chunk_duration_sec
        for _ in range(n_threads):
            tasks.put(None)
        log.info(f"Created {chunk_id} chunks", sid)
        setup_us = (time.perf_counter_ns() - setup_t0) // 1000
        if span is not None:
            SPANS.end(span)

        # bounded stream of decoded chunks keeps host memory flat
        results: queue.Queue = queue.Queue(maxsize=max(4, 2 * n_threads))
        init_us = [0] * n_threads
        timings = [native.ScanTiming() for _ in range(n_threads)]
        errors: list[Exception] = []
        # the decode workers' spans carry this file's id
        file_id = SPANS.file() if SPANS.on else None

        def worker(widx: int) -> None:
            try:
                t0 = time.perf_counter_ns()
                reader = self.open_reader(payload.mode)
                init_us[widx] = (time.perf_counter_ns() - t0) // 1000
                scan = getattr(reader, payload.method)
                for task in iter(tasks.get, None):
                    payload.decode(scan, task, results.put, timings[widx],
                                   file_id)
                reader.close()
            except Exception as e:  # noqa: BLE001 — surfaced after join
                errors.append(e)
            finally:
                results.put(None)  # worker-done sentinel

        workers_t0 = time.perf_counter_ns()
        threads = [threading.Thread(target=worker, args=(i,),
                                    name=f"decode-{i}")
                   for i in range(n_threads)]
        for th in threads:
            th.start()

        motion_ts, frames_scanned, heat, dispatch_us, resolve_us = \
            self._feed(payload, results, n_threads, errors)

        span = SPANS.begin("scan.join") if SPANS.on else None
        join_t0 = time.perf_counter_ns()
        for th in threads:
            th.join()
        join_us = (time.perf_counter_ns() - join_t0) // 1000
        if span is not None:
            SPANS.end(span)
        workers_us = (time.perf_counter_ns() - workers_t0) // 1000

        if errors:
            raise RuntimeError(errors[0])

        # the sub-phases, in batch mode too (only a single file prints
        # the table); dispatch and resolve are host time: the detector's
        # calls, and the wait for their batches
        TimingCollector.record(f"parallel_scan[{kind}]",
                               (time.perf_counter_ns() - t_scan) // 1000)
        n = f"({n_threads}T)"
        for name, us in (
                ("  ├─warmup(build)", warmup_us), ("  ├─setup", setup_us),
                ("  ├─workers", workers_us), (f"  │ ├─init {n}", sum(init_us)),
                (f"  │ ├─seek {n}", sum(tm.seek_us for tm in timings)),
                (f"  │ ├─decode {n}", sum(tm.decode_us for tm in timings)),
                (f"  │ └─scatter {n}", sum(tm.analyze_us for tm in timings)),
                ("  ├─dispatch", dispatch_us), ("  ├─resolve", resolve_us),
                ("  └─join", join_us)):
            TimingCollector.record(name, us)

        if heat is not None and frames_scanned:
            self._write_heatmap(heat, frames_scanned, payload.geom)

        return ScanResult(motion_ts, frames_scanned,
                          sum(tm.frames_with_mvs for tm in timings), chunk_id)

    def _feed(self, payload, results: queue.Queue, n_workers: int,
              errors: list) -> tuple:
        """The device feeder: dispatch each decoded part as it comes and
        resolve them in order once the workers are done, so H2D and compute
        overlap decode; it drains on after a failure, or the workers block
        on the bounded queue.  Returns the motion timestamps, the frames,
        the heatmap's cell counts (None without one) and the host time (us)
        of the dispatches and of the resolve."""
        dispatch_us = frames = done_workers = 0
        pending: list[tuple[np.ndarray, object]] = []
        # optional spatial analytics riding the already-decoded masks
        geom = payload.geom
        heat = (np.zeros((geom.gh, geom.gw), np.int64)
                if self.cfg.heatmap_path and payload.activity is not None
                else None)
        while done_workers < n_workers:
            span = SPANS.begin("scan.feeder_wait") if SPANS.on else None
            item = results.get()
            if span is not None:
                SPANS.end(span)
            if item is None:
                done_workers += 1
                continue
            if errors:
                continue  # drain only; a failure is already recorded
            data, pts = item
            t0 = time.perf_counter_ns()
            try:
                resolver = payload.dispatch(data)
            except Exception as e:  # noqa: BLE001 — surfaced after drain
                errors.append(e)
                continue
            dispatch_us += (time.perf_counter_ns() - t0) // 1000
            frames += len(pts)
            if heat is not None:
                heat += payload.activity(data)
            pending.append((pts, resolver))

        motion_ts: list[float] = []
        t0 = time.perf_counter_ns()
        try:
            for pts, resolver in pending:
                motion_ts.extend(pts[resolver()].tolist())
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        resolve_us = (time.perf_counter_ns() - t0) // 1000
        return motion_ts, frames, heat, dispatch_us, resolve_us

    def _write_heatmap(self, counts: np.ndarray, frames: int, geom) -> None:
        """Per-video spatial activity JSON (MVT_HEATMAP names a directory
        or a file; directories get <input-basename>.heatmap.json)."""
        path = self.cfg.heatmap_path
        if os.path.isdir(path):
            base = os.path.basename(self.input_path) + ".heatmap.json"
            path = os.path.join(path, base)
        elif self.stream_id >= 0:
            # batch mode with a FILE target: parallel streams would race
            # open(path, "w"); suffix per input like the directory branch
            path = f"{path}.{os.path.basename(self.input_path)}.json"
            log.warn("MVT_HEATMAP names a file but batch mode has one "
                     f"heatmap per input; writing {path}", self.stream_id)
        activity = counts / frames
        doc = {
            "input": self.input_path,
            "grid": [geom.gh, geom.gw],
            "frames_analyzed": frames,
            "mean_activity": round(float(activity.mean()), 6),
            "max_activity": round(float(activity.max()), 4),
            "activity": [[round(float(v), 4) for v in row]
                         for row in activity],
        }
        try:
            with open(path, "w") as f:
                json.dump(doc, f)
            log.info(f"Heatmap written to {path}", self.stream_id)
        except OSError as e:
            log.warn(f"heatmap export failed: {e}", self.stream_id)

    # --- cut summary (pipeline.cpp:419-448) ---

    def print_cut_summary(self) -> None:
        log.print_cut_summary(self.duration, self.time_removed,
                              self.saved_pct, self.stream_id)
