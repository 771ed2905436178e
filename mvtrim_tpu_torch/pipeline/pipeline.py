"""Single-video processing pipeline.

The reference's per-video orchestration (pipeline.cpp:89-415) on a
host-decode / device-analyze split, as in ``mvtrim_tpu/pipeline``:

  probe -> chunked parallel host decode (threads over a shared task queue,
  each with its own mmap'd decoder; ctypes releases the GIL) -> per-chunk
  payloads stream through the detector (MVClusterDetector on the CUDA
  word-cluster, cluster-map or fused raw-MV kernel; SADDetector on the
  block-SAD and cluster-map kernels) -> motion timestamps -> merge
  (sort+unique) -> gap segmentation with padding -> savings decision ->
  lossless cut (direct or via CutQueue).

This port runs the MV scan over the ``bits``, ``words``, ``grids`` and
``mv_raw`` payloads and the pixel-domain SAD scan (``MVT_PIPELINE=sad``,
and the ``auto`` fallback when no frame carries MV side data).  Phase
accounting mirrors the reference's timing tree (pipeline.cpp:274-292).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
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
from ..utils.timing import (SPANS, TimingCollector, chrome_events,
                            follow_profiler, start_recording, stop_recording,
                            timer)
from ..models.mv_detector import MVClusterDetector
from ..models.sad_detector import SADDetector
from ..ops.cluster import word_geometry


@dataclasses.dataclass
class ScanResult:
    motion_ts: list[float]
    frames_scanned: int
    frames_with_mvs: int
    chunks: int


class _Profile:
    """MVT_PROFILE_DIR: a torch.profiler trace of a batch or of one file's
    run, held once in a process (the profiler is process-global), with
    the program's spans (``utils.timing``) beside the host and device
    events, written as one Chrome trace into the directory."""

    _traces = itertools.count()

    def __init__(self, out_dir: str):
        import torch
        from torch import profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        self.path = os.path.join(
            out_dir, f"trace_{os.getpid()}_{next(self._traces)}.json")
        self.prof = tp.profile(activities=acts)
        self.prof.__enter__()
        self.owns_spans = start_recording()

    def close(self) -> None:
        self.prof.__exit__(None, None, None)
        spans = stop_recording() if self.owns_spans else SPANS.recorded()
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self.prof.export_chrome_trace(self.path)
            with open(self.path) as f:
                doc = json.load(f)
            doc["traceEvents"].extend(chrome_events(
                spans, int(doc.get("baseTimeNanoseconds", 0)), os.getpid()))
            with open(self.path, "w") as f:
                json.dump(doc, f)
        except (OSError, ValueError) as e:
            log.warn(f"profiler trace export failed: {e}")


def mv_restart_capacity(largest: int, unseen: bool = False) -> int:
    """The capacity a raw-MV chunk is decoded again at once a call
    overflowed, from the largest MV count of that call: an eighth of
    headroom over it in steps of 1,024 rows, so a steady camera's next
    chunks fit too, and never more than the power of two that holds it.
    Where the call stopped at its frame cap with frames of the chunk
    still ``unseen``, whose counts may be larger, it is that power of
    two, so a chunk decoded in sub-calls restarts where and as often as
    it does at the power of two alone."""
    pow2 = 1 << (largest - 1).bit_length()
    if unseen:
        return pow2
    return min(pow2, -(-(largest + largest // 8) // 1024) * 1024)


@contextlib.contextmanager
def held_trace(profile_dir: str):
    """Hold MVT_PROFILE_DIR's trace around a batch or a single file.
    Without it, a ``torch.profiler`` session the caller holds turns the
    program's spans on for the while (``timing.follow_profiler``)."""
    profile = None
    if profile_dir:
        try:
            profile = _Profile(profile_dir)
        except RuntimeError as e:
            log.warn(f"profiler trace unavailable ({e}); "
                     "continuing unprofiled")
    following = profile is None and follow_profiler()
    try:
        yield
    finally:
        if profile is not None:
            profile.close()
        elif following:
            SPANS.pause()


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
            # a typo ("SAD", "sda") would otherwise silently select the MV
            # scan WITHOUT the auto-SAD fallback — the opposite of what the
            # operator configured (same guard as MVT_SCAN_INPUT below)
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
            TimingCollector.record(
                "total_run", (time.perf_counter_ns() - t_total) // 1000)
            if sid < 0:
                TimingCollector.print_summary()
            self._emit_metrics(result, 0, None, t_total)
            return 0

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

        TimingCollector.record(
            "total_run", (time.perf_counter_ns() - t_total) // 1000)
        if sid < 0:
            TimingCollector.print_summary()
        self.print_cut_summary()
        self._emit_metrics(result, int(timestamps.size), is_cut, t_total)
        return 0

    def _emit_metrics(self, result: ScanResult, motion_frames: int,
                      is_cut: bool | None, t_total: int) -> None:
        """Structured per-video metrics (MVT_METRICS_JSON, append-only
        JSON lines) — the metrics export the reference lacks."""
        if not self.cfg.metrics_json:
            return
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

    # --- scan phase (pipeline.cpp:127-295) ---

    def _scan_thread_count(self, num_chunks: int) -> int:
        """Thread count rules (pipeline.cpp:129-143): explicit per-stream
        count in batch mode, else max(2, cgroup-aware cpu limit), always
        capped by the chunk count."""
        if self.num_threads > 0:
            n = self.num_threads
        else:
            n = max(2, system.detect_cpu_limit())
        if self.cfg.decode_workers > 0:
            n = self.cfg.decode_workers
        return max(1, min(n, num_chunks))

    def _scan_input(self) -> str:
        """The MV payload (MVT_SCAN_INPUT):
          bits  — host-thresholded activity masks, bit-packed (default)
          words — the same masks emitted natively in the kernel's int32
                  word layout: the per-batch repack moves into the
                  GIL-released decode workers
          grids — uint8 vote grids, thresholded on the device by the
                  cluster-map kernel
          mv_raw — raw MV fields, thresholded, scattered and clustered on
                  the device by the fused raw-MV kernel (for hosts whose
                  CPU cannot keep up with the vote scatter)
        """
        sid = self.stream_id
        scan_input = self.cfg.scan_input
        if scan_input not in ("bits", "words", "grids", "mv_raw"):
            log.warn(f"Unknown MVT_SCAN_INPUT={scan_input!r}; using bits",
                     sid)
            return "bits"
        if scan_input == "grids" and self.cfg.vectors_needed == 0:
            # raw vote grids cannot tell "no MV side data" from "side data
            # but every MV filtered" at vec_need 0; the packed masks can,
            # and decide identically otherwise
            log.info("VECTORS_NEEDED=0: vote grids are ambiguous for "
                     "MV-less frames; using the bits payload "
                     "(identical decisions)", sid)
            return "bits"
        if scan_input == "mv_raw" and self.cfg.heatmap_path:
            log.warn("MVT_HEATMAP is unavailable with MVT_SCAN_INPUT="
                     "mv_raw (no per-cell grids on host); skipping heatmap",
                     sid)
        return scan_input

    def _parallel_scan(self, kind: str, fps: float, width: int,
                       height: int) -> ScanResult:
        """Chunked parallel decode + batched device analysis.

        kind: 'mv' (MV payload -> cluster kernel) or 'sad' (luma -> block
        SAD kernel -> cluster-map kernel).
        """
        sid = self.stream_id
        cfg = self.cfg
        if kind == "mv":
            scan_input = self._scan_input()
            detector = MVClusterDetector(width, height, cfg,
                                         device=self.device)
        else:
            scan_input = "luma"
            detector = SADDetector(width, height, cfg, device=self.device)
        geom = detector.geom
        frame_skip = cfg.frame_skip(fps)

        num_chunks = max(1, math.ceil(self.duration /
                                      cfg.chunk_duration_sec))
        n_threads = self._scan_thread_count(num_chunks)
        # luma chunks are large (H*W bytes/frame); cap frames per scan call
        if cfg.chunk_frames_cap > 0:
            chunk_frames_cap = cfg.chunk_frames_cap
        elif kind == "sad":
            chunk_frames_cap = max(
                16, (512 * 1024 * 1024) // max(1, width * height)
                // max(1, n_threads))
        else:
            chunk_frames_cap = 1 << 30

        log.phase(
            f"Parallel {'SAD ' if kind == 'sad' else ''}Scan "
            f"({n_threads} threads, {cfg.chunk_duration_sec:.0f}s chunks)...",
            sid)

        t_scan = time.perf_counter_ns()

        # analyzed-frame cap per native scan call
        max_frames = min(
            chunk_frames_cap,
            int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64)

        # Warm the device path BEFORE spawning decode threads: the first
        # call builds the CUDA kernels (nvcc, once per source set) and makes
        # the first launch, host-CPU work that would contend with the
        # decoders
        span = SPANS.begin("scan.warmup") if SPANS.on else None
        warm_t0 = time.perf_counter_ns()
        if kind == "sad":
            detector.scan_luma(np.zeros((2, height, width), np.uint8))
        elif scan_input == "bits":
            detector.scan_bits(
                np.zeros((1, geom.gh, (geom.gw + 7) // 8), np.uint8))
        elif scan_input == "words":
            detector.scan_words(
                np.zeros((1, word_geometry(geom)[1]), np.int32))
        elif scan_input == "mv_raw":
            detector.scan_raw_mvs(np.zeros((1, cfg.mv_capacity, 4), np.int16),
                                  np.zeros((1,), np.int32))
        else:
            detector.scan_votes(np.zeros((1, geom.gh, geom.gw), np.uint8))
        warmup_us = (time.perf_counter_ns() - warm_t0) // 1000
        if span is not None:
            SPANS.end(span)

        span = SPANS.begin("scan.setup") if SPANS.on else None
        setup_t0 = time.perf_counter_ns()

        tasks: queue.Queue[ScanTask | None] = queue.Queue()
        chunk_id = 0
        t = 0.0
        while t < self.duration:
            end = min(t + cfg.chunk_duration_sec, self.duration)
            tasks.put(ScanTask(t, end, chunk_id))
            chunk_id += 1
            t += cfg.chunk_duration_sec
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

        reader_mode = (native.MVT_MODE_MV if kind == "mv"
                       else native.MVT_MODE_LUMA)
        # native scan_<payload> arguments beyond the shared ones
        scan_args = {} if kind == "sad" else dict(
            threshold_sq=cfg.mv_threshold_sq, block_shift=cfg.block_shift,
            gw=geom.gw, gh=geom.gh, y_min=geom.y_min, y_max=geom.y_max)
        if scan_input in ("bits", "words"):
            scan_args["vectors_needed"] = cfg.vectors_needed
        # the decode workers' spans carry this file's id
        file_id = SPANS.file() if SPANS.on else None
        # the mv_raw capacity of this file, shared by its decode workers:
        # it starts at MVT_MV_CAPACITY and only grows, to what a restart
        # chose, so a noisy camera's later chunks start at a capacity that
        # holds them and a quiet one's never leave MVT_MV_CAPACITY
        file_cap = [cfg.mv_capacity]
        cap_lock = threading.Lock()

        def worker(widx: int) -> None:
            try:
                t0 = time.perf_counter_ns()
                reader = self.open_reader(reader_mode)
                init_us[widx] = (time.perf_counter_ns() - t0) // 1000
                scan = getattr(reader, "scan_mvs" if scan_input == "mv_raw"
                               else f"scan_{scan_input}")
                while True:
                    task = tasks.get()
                    if task is None:
                        break
                    # resume when the frame cap saturates (VFR bursts can
                    # exceed the probed-fps estimate; dropping the chunk
                    # tail would lose motion).  resume=True continues the
                    # decode from the exact stream position with the
                    # frame-skip counter carried on the handle, so a capped
                    # chunk analyzes the same frame set as the reference's
                    # uncapped scan (motion_scanner.cpp:314,356-357).
                    # The luma path also sub-chunks when its memory cap
                    # binds, and threads the last analyzed frame of each
                    # sub-scan into the next as its carry, so the first
                    # frame of a resumed sub-scan is compared to its real
                    # predecessor: the cap never changes decisions.
                    # The mv_raw payload starts each chunk at the file's
                    # capacity and restarts the whole chunk when a
                    # frame's MVs overflow it (see below).
                    resume = False
                    luma_carry = None
                    cap = file_cap[0]
                    if SPANS.on and cap > cfg.mv_capacity:
                        # zero-length: the chunk starts at a capacity
                        # carried from the file's earlier chunks
                        SPANS.end(SPANS.begin("scan.mv_carried", file_id),
                                  cap)
                    emitted = 0       # frames queued from this chunk
                    skip_dup = 0      # duplicates to drop after a restart
                    mv_base = timings[widx].frames_with_mvs
                    while True:
                        span = (SPANS.begin("scan.decode", file_id)
                                if SPANS.on else None)
                        if scan_input == "mv_raw":
                            mvs, counts, pts = scan(
                                task.start, task.end, frame_skip=frame_skip,
                                max_frames=max_frames, max_mv=cap,
                                timing=timings[widx], resume=resume)
                            raw_n = len(pts)
                            if span is not None:
                                SPANS.end(span, raw_n)
                            if raw_n and (counts < 0).any():
                                # capacity overflow: restart the WHOLE
                                # chunk from a fresh seek at a capacity
                                # that fits every frame of this call with
                                # room to spare (mv_restart_capacity; the
                                # power of two if the call stopped at
                                # max_frames), so the decision is over the
                                # complete MV lists (the detector takes
                                # them at that capacity), and raise the
                                # file's capacity to it for the chunks
                                # still to start.
                                # Decode is deterministic, so the restart
                                # replays the frames already queued from
                                # this chunk: drop those duplicates, and
                                # rewind the native frames_with_mvs
                                # counter so the re-decode counts each
                                # frame once.
                                cap = mv_restart_capacity(
                                    int(-counts.min()),
                                    unseen=raw_n == max_frames)
                                with cap_lock:
                                    file_cap[0] = max(file_cap[0], cap)
                                if SPANS.on:
                                    # zero-length: the frames decoded in
                                    # vain (this call's and the queued ones
                                    # the restart decodes again and drops),
                                    # and the capacity chosen, in the name
                                    SPANS.end(SPANS.begin("scan.mv_restart"),
                                              raw_n + emitted)
                                    SPANS.end(SPANS.begin(
                                        f"scan.mv_capacity.{cap}"), cap)
                                resume = False
                                skip_dup = emitted
                                timings[widx].frames_with_mvs = mv_base
                                continue
                            k = min(skip_dup, raw_n)
                            skip_dup -= k
                            item = ((mvs[k:], counts[k:]), pts[k:])
                        else:
                            data, pts = scan(
                                task.start, task.end, **scan_args,
                                frame_skip=frame_skip, max_frames=max_frames,
                                timing=timings[widx], resume=resume)
                            raw_n = len(pts)
                            if span is not None:
                                SPANS.end(span, raw_n)
                            item = (data, pts)
                            if kind == "sad":
                                item = ((data, luma_carry), pts)
                                if len(data):
                                    luma_carry = data[-1].copy()
                        if raw_n == 0:
                            break
                        if len(item[1]):  # empty after a duplicate drop
                            emitted += len(item[1])
                            results.put(item)
                        if raw_n < max_frames:
                            break
                        resume = True
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

        # device feeder: consume chunks, dispatch asynchronously, resolve
        # at the end so H2D+compute overlap decode.  Keep draining even
        # after a detector failure: decode workers block on the bounded
        # queue otherwise and the process never exits.
        if kind == "sad":
            def dispatch(data):
                # the SAD scan decides each sub-scan on the spot
                motion = detector.scan_luma(data[0], carry=data[1])
                return lambda: motion
        elif scan_input == "mv_raw":
            def dispatch(data):
                return detector.scan_raw_mvs_async(*data)
        else:
            dispatch = {"bits": detector.scan_bits_async,
                        "words": detector.scan_words_async,
                        "grids": detector.scan_votes_async}[scan_input]
        dispatch_us = 0
        pending: list[tuple[np.ndarray, object]] = []
        frames_scanned = 0
        done_workers = 0
        # optional spatial analytics riding the already-decoded masks
        heat_acc = (np.zeros((geom.gh, geom.gw), np.int64)
                    if (cfg.heatmap_path and kind == "mv"
                        and scan_input != "mv_raw") else None)
        while done_workers < n_threads:
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
                resolver = dispatch(data)
            except Exception as e:  # noqa: BLE001 — surfaced after drain
                errors.append(e)
                continue
            dispatch_us += (time.perf_counter_ns() - t0) // 1000
            frames_scanned += len(pts)
            if heat_acc is not None and scan_input == "grids":
                heat_acc += (data >= cfg.vectors_needed).sum(
                    axis=0, dtype=np.int64)
            elif heat_acc is not None:
                # words is the same little-endian bit layout viewed as
                # int32 lanes — one byte view, shared accumulation
                packed = (data if scan_input == "bits" else
                          data.view(np.uint8).reshape(len(pts), geom.gh, -1))
                heat_acc += np.unpackbits(
                    packed, axis=2, bitorder="little")[:, :, :geom.gw].sum(
                        axis=0, dtype=np.int64)
            pending.append((pts, resolver))

        motion_ts: list[float] = []
        t0 = time.perf_counter_ns()
        try:
            for pts, resolver in pending:
                motion = resolver()
                motion_ts.extend(pts[motion].tolist())
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        resolve_us = (time.perf_counter_ns() - t0) // 1000

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

        scan_us = (time.perf_counter_ns() - t_scan) // 1000
        # the sub-phases, in batch mode too (only a single file prints
        # the table); dispatch and resolve are host time: the detector's
        # calls, and the wait for their batches
        TimingCollector.record(f"parallel_scan[{kind}]", scan_us)
        tot = native.ScanTiming()
        for tm in timings:
            tot.seek_us += tm.seek_us
            tot.decode_us += tm.decode_us
            tot.analyze_us += tm.analyze_us
        TimingCollector.record("  ├─warmup(build)", warmup_us)
        TimingCollector.record("  ├─setup", setup_us)
        TimingCollector.record("  ├─workers", workers_us)
        TimingCollector.record(f"  │ ├─init ({n_threads}T)", sum(init_us))
        TimingCollector.record(f"  │ ├─seek ({n_threads}T)", tot.seek_us)
        TimingCollector.record(f"  │ ├─decode ({n_threads}T)", tot.decode_us)
        TimingCollector.record(f"  │ └─scatter ({n_threads}T)",
                               tot.analyze_us)
        TimingCollector.record("  ├─dispatch", dispatch_us)
        TimingCollector.record("  ├─resolve", resolve_us)
        TimingCollector.record("  └─join", join_us)

        if heat_acc is not None and frames_scanned:
            self._write_heatmap(heat_acc, frames_scanned, geom)

        frames_with_mvs = sum(tm.frames_with_mvs for tm in timings)
        return ScanResult(motion_ts, frames_scanned, frames_with_mvs,
                          chunk_id)

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
