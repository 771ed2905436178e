"""Multi-video batch scheduler + watch mode.

Rebuilds the reference BatchProcessor (batch_processor.cpp:48-433): a work
queue of videos, N concurrent stream workers, one cut-consumer thread, an
optional directory watcher, and the wall-clock/speedup summary.

Differences from the reference, by design:
* CPU pinning / disjoint cpusets disappear — decode threads are scheduled
  by the OS and analysis batches share the card; on a host with several
  cards streams are assigned to cards round-robin instead of to cpusets.
* stream workers are threads, not pinned OS threads: the native decode
  layer releases the GIL, so N streams decode genuinely in parallel.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import dataclasses

import torch

from ..core.config import Config
from ..cut.executor import CutQueue
from ..utils import logging as log
from ..utils import system
from ..utils.timing import SPANS, TimingCollector, held_trace
from ..pipeline.pipeline import ProcessingPipeline

VIDEO_EXTENSIONS = {".mp4", ".mkv", ".ts", ".mov", ".avi"}  # main.cpp:68-69


def list_videos(input_dir: str) -> list[str]:
    """Collect + sort video files by extension (main.cpp:62-74)."""
    files = []
    for name in os.listdir(input_dir):
        path = os.path.join(input_dir, name)
        if os.path.isfile(path) and \
                os.path.splitext(name)[1].lower() in VIDEO_EXTENSIONS:
            files.append(path)
    return sorted(files)


@dataclasses.dataclass
class StreamResult:
    """Per-file outcome (batch_processor.hpp:52-59)."""

    filename: str
    success: bool
    processing_time_us: int


class BatchProcessor:
    """Parallel multi-video processing with deferred cuts."""

    def __init__(self, num_streams: int = 0, cfg: Config | None = None):
        self.cfg = cfg or Config.from_env()
        if num_streams <= 0:
            self.num_streams = system.calculate_parallel_streams(
                self.cfg.threads_per_stream)
        else:
            # respect user config but cap at the cgroup-aware CPU limit
            # (batch_processor.cpp:37-46)
            self.num_streams = max(
                1, min(num_streams, system.detect_cpu_limit()))
        self._work: queue.Queue[str] = queue.Queue()
        self._seen: set[str] = set()
        self._lock = threading.Lock()
        self._new_work = threading.Condition(self._lock)
        self._stop_watch = threading.Event()
        self._abort = threading.Event()
        self._results: list[StreamResult] = []
        self._total_files = 0

    def _plan_streams(self, total_files: int, watch: bool) -> int:
        """Worker-thread count.  In watch mode the initial file count says
        nothing about future load — the daemon keeps full concurrency for
        its lifetime (the reference caps by CPUs only,
        batch_processor.cpp:81-83).  One-shot batches don't spawn workers
        that could never receive a file."""
        if watch:
            return max(1, self.num_streams)
        return max(1, min(self.num_streams,
                          total_files or self.num_streams))

    # --- main entry (batch_processor.cpp:48-213) ---

    def process(self, input_files: list[str], output_dir: str,
                input_dir: str = "") -> int:
        """Run the batch (or the watch daemon) to its end; returns the
        failures.  MVT_PROFILE_DIR's trace is held over all of it."""
        watch = self.cfg.watch_mode
        if not input_files and not watch:
            log.warn("No input files to process")
            return 0
        with held_trace(self.cfg.profile_dir):
            return self._process(input_files, output_dir, input_dir, watch)

    def _process(self, input_files: list[str], output_dir: str,
                 input_dir: str, watch: bool) -> int:
        os.makedirs(output_dir, exist_ok=True)
        span = SPANS.begin("batch.enqueue") if SPANS.on else None
        for f in input_files:
            self._seen.add(f)
            out = os.path.join(output_dir, os.path.basename(f))
            if os.path.exists(out):
                log.info(f"Skipping existing output: {out}")
                continue
            self._work.put(f)
        self._total_files = self._work.qsize()
        if span is not None:
            SPANS.end(span, self._total_files)

        actual_streams = self._plan_streams(self._total_files, watch)
        threads_per_stream = self.cfg.threads_per_stream
        if threads_per_stream <= 0:
            threads_per_stream = max(
                1, system.detect_cpu_limit() // actual_streams)

        log.phase("================== BATCH PROCESSING ==================")
        log.info(f"Files to process: {self._total_files}")
        log.info(f"Parallel streams: {actual_streams}")
        log.info(f"Decode threads per stream: {threads_per_stream}")
        log.phase("=======================================================")

        batch_start = time.perf_counter()
        cut_queue = CutQueue(self.cfg)

        streams = [
            threading.Thread(
                target=self._stream_worker,
                args=(i, threads_per_stream, output_dir, cut_queue),
                name=f"stream-{i}")
            for i in range(actual_streams)
        ]
        for s in streams:
            s.start()

        if watch:
            if not input_dir and input_files:
                input_dir = os.path.dirname(input_files[0])
            input_dir = input_dir or "."
            log.info(f"Starting Watch Mode on directory: {input_dir}")
            monitor = threading.Thread(
                target=self._monitor_directory, args=(input_dir, output_dir),
                name="watch-monitor")
            monitor.start()
            try:
                monitor.join()  # blocks until stop_watch / interrupt
            except KeyboardInterrupt:
                # Ctrl+C must terminate the daemon cleanly: the monitor and
                # stream workers are non-daemon threads, so letting the
                # interrupt propagate would leave them polling forever and
                # hang interpreter shutdown (the C++ reference's SIGINT
                # default kills the whole process; a Python daemon has to
                # stop its threads itself).
                log.warn("Interrupted — stopping watch mode...")
                self.abort()
                monitor.join()

        try:
            for s in streams:
                s.join()
        except KeyboardInterrupt:
            # same story outside watch mode: request a stop (workers finish
            # the file in flight, then exit) and wait for them.
            log.warn("Interrupted — waiting for in-flight files...")
            self.abort()
            for s in streams:
                s.join()
        cut_failures = cut_queue.finish()

        elapsed = time.perf_counter() - batch_start
        self._print_batch_summary(elapsed)

        failures = sum(1 for r in self._results if not r.success)
        return failures + cut_failures

    def stop(self) -> None:
        """Terminate watch mode (the reference's stop_watch_ is never set —
        SURVEY.md §3.3; we make it reachable).  Queued work still drains
        before the workers exit — the RSS watchdog relies on that."""
        self._stop_watch.set()
        with self._new_work:
            self._new_work.notify_all()

    def abort(self) -> None:
        """User interrupt: stop AND drop the queued backlog — workers
        finish only the file currently in flight."""
        self._abort.set()
        self.stop()

    # --- work distribution (batch_processor.cpp:215-235) ---

    def _get_next_file(self) -> str | None:
        if self._abort.is_set():
            return None  # interrupt: drop the backlog, finish in-flight
        if self.cfg.watch_mode:
            with self._new_work:
                while self._work.empty() and not self._stop_watch.is_set():
                    self._new_work.wait(timeout=0.5)
                if self._work.empty() or self._abort.is_set():
                    return None
                return self._work.get_nowait()
        try:
            return self._work.get_nowait()
        except queue.Empty:
            return None

    # --- watch mode (batch_processor.cpp:237-305) ---

    def _monitor_directory(self, input_dir: str, output_dir: str) -> None:
        poll_count = 0
        rss_limit = self.cfg.rss_limit_mb
        while not self._stop_watch.is_set():
            try:
                if poll_count % 15 == 0:
                    log.info(f"[Watch] Monitoring directory: {input_dir} "
                             "(Waiting for new files...)")
                if rss_limit > 0:
                    # RSS watchdog: long-lived daemons on leaky transports
                    # (e.g. HTTP-tunneled PJRT clients — see
                    # benchmarks/soak_watch.py) grow without a framework
                    # bug; past the bound we drain and exit so the
                    # supervisor (docker-compose restart policy, systemd)
                    # relaunches a fresh process.
                    rss = system.rss_mb()
                    if rss > rss_limit:
                        log.error(
                            f"[Watch] RSS {rss:.0f}MB exceeds "
                            f"MVT_RSS_LIMIT_MB={rss_limit:.0f}; stopping "
                            "watch mode for supervisor restart")
                        self.stop()
                        break
                poll_count += 1
                for path in list_videos(input_dir):
                    if path in self._seen:
                        continue
                    out = os.path.join(output_dir, os.path.basename(path))
                    if os.path.exists(out):
                        log.info("[Watch] Skipping file (already processed):"
                                 f" {os.path.basename(path)}")
                        self._seen.add(path)
                        continue
                    # stability check: size unchanged over 500ms
                    # (batch_processor.cpp:273-278)
                    size1 = os.path.getsize(path)
                    time.sleep(0.5)
                    size2 = os.path.getsize(path)
                    if size1 != size2:
                        continue
                    log.info(f"[Watch] New file detected: "
                             f"{os.path.basename(path)}")
                    with self._new_work:
                        self._work.put(path)
                        self._seen.add(path)
                        self._total_files += 1
                        self._new_work.notify()
            except OSError as e:
                log.error(f"[Watch] Error scanning directory: {e}")
            self._stop_watch.wait(timeout=2.0)
        with self._new_work:
            self._new_work.notify_all()

    # --- stream worker (batch_processor.cpp:307-382) ---

    def _stream_worker(self, stream_id: int, threads_per_stream: int,
                       output_dir: str, cut_queue: CutQueue) -> None:
        # several cards: each stream's dispatches land on its own card
        # (round-robin), replacing the reference's disjoint cpusets
        n_cards = torch.cuda.device_count()
        device = torch.device(f"cuda:{stream_id % n_cards}") \
            if n_cards > 1 else None
        if device is not None:
            log.info(f"Analysis device: {device}", stream_id)

        while True:
            # a file's spans: the wait for it, then its run to its result
            file_span = span = None
            if SPANS.on:
                SPANS.new_file()
                file_span = SPANS.begin("batch.file")
                span = SPANS.begin("batch.next_file")
            path = self._get_next_file()
            if span is not None:
                SPANS.end(span)
            if path is None:
                if file_span is not None:
                    SPANS.end(file_span, stream_id)
                break
            out = os.path.join(output_dir, os.path.basename(path))
            log.phase("----------------------------------------", stream_id)
            log.info(f"Processing: {os.path.basename(path)}", stream_id)

            t0 = time.perf_counter_ns()
            pipeline = ProcessingPipeline(
                path, out, stream_id=stream_id,
                num_threads=threads_per_stream, cfg=self.cfg,
                cut_queue=cut_queue, device=device)
            try:
                ret = pipeline.run()
            except Exception as e:  # noqa: BLE001 — batch keeps going
                log.error(f"Pipeline crashed: {e}", stream_id)
                ret = 1
            dt_us = (time.perf_counter_ns() - t0) // 1000

            result = StreamResult(os.path.basename(path), ret == 0, dt_us)
            with self._lock:
                self._results.append(result)
            if file_span is not None:
                SPANS.end(file_span, stream_id)
            if result.success:
                log.success(
                    f"Completed: {result.filename} ({dt_us / 1e6:.1f}s)",
                    stream_id)
            else:
                log.error(f"Failed: {result.filename}", stream_id)
            TimingCollector.clear()
        log.info("Finished (no more files)", stream_id)

    # --- summary (batch_processor.cpp:384-433) ---

    def _print_batch_summary(self, wall_clock_sec: float) -> None:
        total = len(self._results)
        success = sum(1 for r in self._results if r.success)
        failed = total - success
        sum_time = sum(r.processing_time_us for r in self._results) / 1e6
        speedup = sum_time / wall_clock_sec if wall_clock_sec > 0 else 1.0

        print()
        print("============== BATCH PROCESSING SUMMARY ==============")
        print(f"{'Total files:':<25} {total:>25}")
        print(f"{'Successful:':<25} {success:>25}")
        print(f"{'Failed:':<25} {failed:>25}")
        print(f"{'Parallel streams:':<25} {self.num_streams:>25}")
        print(f"{'Wall-clock time:':<25} {wall_clock_sec:>22.1f}s")
        print(f"{'Sum of file times:':<25} {sum_time:>22.1f}s")
        print(f"{'Speedup:':<25} {speedup:>22.2f}x")
        if total:
            print(f"{'Average time per file:':<25} {sum_time / total:>22.1f}s")
        print("======================================================",
              flush=True)
        if failed:
            print("\nFailed files:")
            for r in self._results:
                if not r.success:
                    print(f"  - {r.filename}")
