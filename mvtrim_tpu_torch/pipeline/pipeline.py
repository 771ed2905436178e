"""Single-video processing pipeline.

The reference's per-video orchestration (pipeline.cpp:89-415) on a
host-decode / device-analyze split, as in ``mvtrim_tpu/pipeline``:

  probe -> chunked parallel host decode (threads over a shared task queue,
  each with its own mmap'd decoder; ctypes releases the GIL) -> per-chunk
  payloads stream through the detector (MVClusterDetector on the CUDA
  word-cluster or cluster-map kernel; SADDetector on the block-SAD and
  cluster-map kernels) -> motion timestamps -> merge (sort+unique) -> gap
  segmentation with padding -> savings decision -> lossless cut (direct or
  via CutQueue).

This port runs the MV scan over the ``bits``, ``words`` and ``grids``
payloads and the pixel-domain SAD scan (``MVT_PIPELINE=sad``, and the
``auto`` fallback when no frame carries MV side data).  The ``mv_raw``
payload is not ported yet: choosing it fails the video with a message
naming its ROADMAP.md item.  Phase accounting mirrors the reference's
timing tree (pipeline.cpp:274-292).
"""

from __future__ import annotations

import dataclasses
import math
import os
import queue
import threading
import time

import numpy as np

from mvtrim_tpu.core import oracle
from mvtrim_tpu.core.config import Config
from mvtrim_tpu.core.types import ScanTask
from mvtrim_tpu.cut.executor import CutJob, CutQueue, execute_cut
from mvtrim_tpu.io import native
from mvtrim_tpu.utils import logging as log
from mvtrim_tpu.utils import system
from mvtrim_tpu.utils.logging import format_time
from mvtrim_tpu.utils.timing import TimingCollector, timer

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
    """MVT_PROFILE_DIR: a torch.profiler trace of the run, written as a
    Chrome trace into the directory.  The profiler is process-global, so
    in batch mode only one stream holds it; the others run unprofiled."""

    def __init__(self, out_dir: str, stream_id: int):
        import torch
        from torch import profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        self.path = os.path.join(
            out_dir, f"trace_{os.getpid()}_{max(stream_id, 0)}.json")
        self.prof = tp.profile(activities=acts)
        self.prof.__enter__()

    def close(self, stream_id: int) -> None:
        self.prof.__exit__(None, None, None)
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self.prof.export_chrome_trace(self.path)
        except OSError as e:
            log.warn(f"profiler trace export failed: {e}", stream_id)


class ProcessingPipeline:
    """Process one video: scan for motion, cut out the static parts.

    When ``cut_queue`` is provided (batch mode) the cut job is pushed for
    deferred execution instead of running inline (pipeline.cpp:358-404);
    ``stream_id >= 0`` prefixes log lines; ``device`` pins this stream's
    analysis to one card.
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
        self.duration = 0.0
        self.time_removed = 0.0
        self.saved_pct = 0.0

    # --- main entry ---

    def run(self) -> int:
        sid = self.stream_id
        t_total = time.perf_counter_ns()

        log.phase("Mapping + probing...", sid)
        try:
            with timer("probe"):
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
        profile = None
        if self.cfg.profile_dir:
            try:
                profile = _Profile(self.cfg.profile_dir, sid)
            except RuntimeError as e:
                log.warn(f"profiler trace unavailable ({e}); "
                         "continuing unprofiled", sid)
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
        finally:
            if profile is not None:
                profile.close(sid)

        log.info(f"Processed {result.chunks} chunks, scanned "
                 f"{result.frames_scanned} frames, found "
                 f"{len(result.motion_ts)} motion frames", sid)

        # --- merge + dedupe (pipeline.cpp:302-304) ---
        log.phase("Merging...", sid)
        with timer("merge"):
            timestamps = oracle.merge_timestamps(result.motion_ts)

        if timestamps.size == 0:
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
        import json

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
        if scan_input == "mv_raw":
            raise RuntimeError(
                "MVT_SCAN_INPUT=mv_raw is not ported to mvtrim_tpu_torch "
                "yet: ROADMAP.md queue 1 item 8")
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
        warm_t0 = time.perf_counter_ns()
        if kind == "sad":
            detector.scan_luma(np.zeros((2, height, width), np.uint8))
        elif scan_input == "bits":
            detector.scan_bits(
                np.zeros((1, geom.gh, (geom.gw + 7) // 8), np.uint8))
        elif scan_input == "words":
            detector.scan_words(
                np.zeros((1, word_geometry(geom)[1]), np.int32))
        else:
            detector.scan_votes(np.zeros((1, geom.gh, geom.gw), np.uint8))
        warmup_us = (time.perf_counter_ns() - warm_t0) // 1000

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

        def worker(widx: int) -> None:
            try:
                t0 = time.perf_counter_ns()
                reader = native.VideoReader(self.input_path, reader_mode)
                init_us[widx] = (time.perf_counter_ns() - t0) // 1000
                scan = getattr(reader, f"scan_{scan_input}")
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
                    resume = False
                    luma_carry = None
                    while True:
                        data, pts = scan(
                            task.start, task.end, **scan_args,
                            frame_skip=frame_skip, max_frames=max_frames,
                            timing=timings[widx], resume=resume)
                        item = (data, pts)
                        if kind == "sad":
                            item = ((data, luma_carry), pts)
                            if len(data):
                                luma_carry = data[-1].copy()
                        if len(pts) == 0:
                            break
                        results.put(item)
                        if len(pts) < max_frames:
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
        else:
            dispatch = {"bits": detector.scan_bits_async,
                        "words": detector.scan_words_async,
                        "grids": detector.scan_votes_async}[scan_input]
        device_us = 0
        pending: list[tuple[np.ndarray, object]] = []
        frames_scanned = 0
        done_workers = 0
        # optional spatial analytics riding the already-decoded masks
        heat_acc = (np.zeros((geom.gh, geom.gw), np.int64)
                    if cfg.heatmap_path and kind == "mv" else None)
        while done_workers < n_threads:
            item = results.get()
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
            device_us += (time.perf_counter_ns() - t0) // 1000
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
        device_us += (time.perf_counter_ns() - t0) // 1000

        join_t0 = time.perf_counter_ns()
        for th in threads:
            th.join()
        join_us = (time.perf_counter_ns() - join_t0) // 1000
        workers_us = (time.perf_counter_ns() - workers_t0) // 1000

        if errors:
            raise RuntimeError(errors[0])

        scan_us = (time.perf_counter_ns() - t_scan) // 1000
        TimingCollector.record(f"parallel_scan[{kind}]", scan_us)
        if sid < 0:
            tot = native.ScanTiming()
            for tm in timings:
                tot.seek_us += tm.seek_us
                tot.decode_us += tm.decode_us
                tot.analyze_us += tm.analyze_us
            TimingCollector.record("  ├─warmup(build)", warmup_us)
            TimingCollector.record("  ├─setup", setup_us)
            TimingCollector.record("  ├─workers", workers_us)
            TimingCollector.record(f"  │ ├─init ({n_threads}T)",
                                   sum(init_us))
            TimingCollector.record(f"  │ ├─seek ({n_threads}T)", tot.seek_us)
            TimingCollector.record(f"  │ ├─decode ({n_threads}T)",
                                   tot.decode_us)
            TimingCollector.record(f"  │ └─scatter ({n_threads}T)",
                                   tot.analyze_us)
            TimingCollector.record("  ├─device_scan", device_us)
            TimingCollector.record("  └─join", join_us)

        if heat_acc is not None and frames_scanned:
            self._write_heatmap(heat_acc, frames_scanned, geom)

        frames_with_mvs = sum(tm.frames_with_mvs for tm in timings)
        return ScanResult(motion_ts, frames_scanned, frames_with_mvs,
                          chunk_id)

    def _write_heatmap(self, counts: np.ndarray, frames: int, geom) -> None:
        """Per-video spatial activity JSON (MVT_HEATMAP names a directory
        or a file; directories get <input-basename>.heatmap.json)."""
        import json

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
