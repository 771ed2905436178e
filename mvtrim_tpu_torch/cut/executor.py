"""Lossless cut executors + producer-consumer job queue.

Mirrors the reference's ffmpeg_executor.cpp + ffmpeg_queue.cpp: scanning
producers emit cut jobs; one consumer serializes the disk-heavy cuts
(ffmpeg_queue.hpp:5-12).  Two execution paths:

* native (default): libavformat stream-copy remux in-process
  (native/mvtrim_host.cpp mvt_cut) — no external binary needed.
* external: when MVT_FFMPEG_BIN is set, shell out with the reference's
  exact argument string (concat demuxer, -c copy, +genpts,
  -avoid_negative_ts make_zero, +faststart — pipeline.cpp:517-523) for
  byte-level compatibility with the reference's outputs.

Cut points are %.2f-quantized before execution — the same rounding the
reference applies when writing its concat list (pipeline.cpp:468-469) —
so segment boundaries are bit-identical across both paths.
"""

from __future__ import annotations

import contextlib
import os
import queue
import subprocess
import tempfile
import threading
import dataclasses

from ..core import oracle
from ..core.config import Config
from ..core.types import TimeSegment
from ..io import native
from ..utils import logging as log
from ..utils.system import parse_cpuset_list


def _cut_cpus(cfg: Config) -> set[int] | None:
    """Resolve MVT_CUT_CPUSET to a CPU set, or None when unset/unusable.

    Analog of the reference pinning its ffmpeg child with `taskset -c`
    (pipeline.cpp:500-515).  An unparseable spec warns and runs unpinned —
    a bad cpuset must not turn every cut into a failure.
    """
    if not cfg.cut_cpuset or not hasattr(os, "sched_setaffinity"):
        return None
    try:
        cpus = set(parse_cpuset_list(cfg.cut_cpuset))
    except ValueError:
        log.warn(f"MVT_CUT_CPUSET unparseable: {cfg.cut_cpuset!r} — "
                 "cut runs unpinned")
        return None
    if not cpus:
        # a spec that parses to nothing (e.g. "," or whitespace) is as
        # misconfigured as an unparseable one — warn, don't silently
        # drop the operator's isolation intent
        log.warn(f"MVT_CUT_CPUSET empty: {cfg.cut_cpuset!r} — "
                 "cut runs unpinned")
        return None
    # sched_setaffinity rejects CPUs outside the process's allowed mask
    # (offline ids, cgroup-restricted ids) with EINVAL — pin to the valid
    # subset instead of letting one stale id fail every cut
    avail = os.sched_getaffinity(0)
    usable = cpus & avail
    if not usable:
        log.warn(f"MVT_CUT_CPUSET {sorted(cpus)} has no CPU available to "
                 f"this process (allowed: {sorted(avail)}) — cut runs "
                 "unpinned")
        return None
    if usable != cpus:
        log.warn(f"MVT_CUT_CPUSET: CPUs {sorted(cpus - avail)} not "
                 f"available to this process — pinning to {sorted(usable)}")
    return usable


@contextlib.contextmanager
def _thread_affinity(cpus: set[int] | None):
    """Pin the CALLING THREAD to `cpus` for the duration (restores after).

    sched_setaffinity(0, ...) targets the calling thread on Linux, so
    pinning here bounds the native remux (which runs GIL-released inside
    this thread) without touching the scanning streams — the same
    isolation the reference gets by confining its ffmpeg child to the
    stream's cpuset.
    """
    if cpus is None:
        yield
        return
    prev = os.sched_getaffinity(0)
    try:
        os.sched_setaffinity(0, cpus)
    except OSError as e:
        log.warn(f"cut cpuset {sorted(cpus)} rejected ({e}) — unpinned")
        yield
        return
    try:
        yield
    finally:
        os.sched_setaffinity(0, prev)


@dataclasses.dataclass
class CutJob:
    """FFmpegJob equivalent (ffmpeg_queue.hpp:32-50)."""

    stream_id: int
    input_path: str
    output_path: str
    segments: list[TimeSegment]


def quantized_segments(segments) -> list[tuple[float, float]]:
    """Apply the %.2f concat-list rounding and drop empty segments
    (pipeline.cpp:464-470)."""
    out = []
    for s in segments:
        if s.end <= s.start:
            continue
        start = float(oracle.format_cut_point(s.start))
        end = float(oracle.format_cut_point(s.end))
        if end > start:
            out.append((start, end))
    return out


def execute_cut(input_path: str, output_path: str, segments,
                stream_id: int = -1, cfg: Config | None = None) -> int:
    """Cut input to output keeping only the given segments. Returns 0/err.

    The cut is ALWAYS attempted once the savings decision passed — the
    reference invokes ffmpeg even when every segment is zero-length and
    the concat list comes out empty (execute_cut writes nothing for
    end <= start segments, pipeline.cpp:464-470, but still runs the
    command and logs its failure, :533-556).  Found by the round-3
    400-seed differential fuzz (PADDING_SEC=0 + isolated motion frames
    -> all segments zero-length -> the reference cuts with an empty
    list while we used to skip silently, diverging the captured lists).
    """
    cfg = cfg or Config.from_env()
    abs_input = os.path.abspath(input_path)
    cpus = _cut_cpus(cfg)
    try:
        if cfg.ffmpeg_bin:
            # reference-exact list text: built from the UNQUANTIZED
            # segments (oracle.concat_list drops end <= start and
            # formats %.2f — a sub-0.01s segment is WRITTEN with equal
            # in/outpoints, exactly like the reference)
            _external_cut(cfg.ffmpeg_bin, output_path,
                          oracle.concat_list(abs_input, segments),
                          cpus=cpus)
        else:
            segs = quantized_segments(segments)
            if not segs:
                # native analog of the reference's empty-list ffmpeg
                # run: error logged, no output created, processing
                # continues (the reference's ffmpeg exits nonzero and
                # is only logged)
                raise RuntimeError(
                    "empty cut list (all segments zero-length)")
            with _thread_affinity(cpus):
                native.cut(abs_input, output_path, segs)
    except Exception as e:  # noqa: BLE001 — cut failure is logged, not fatal
        # reference behavior: log the error and continue (pipeline.cpp:549-556)
        log.error(f"Cut failed: {e}", stream_id)
        return 1
    log.success(f"Output saved to: {output_path}", stream_id)
    return 0


def _concat_list_fd(text: str):
    """Concat list as an anonymous in-memory file.

    The reference writes the list to a memfd and hands ffmpeg the
    /proc/<pid>/fd/<fd> path (pipeline.cpp:476-498) — no disk write, no
    cleanup, vanishes with the fd.  Same mechanism here; callers fall
    back to a temp file where memfd_create is unavailable (non-Linux).

    Returns (path, fd or None, unlink_needed).
    """
    if hasattr(os, "memfd_create"):
        fd = os.memfd_create("mvt_concat")
        os.write(fd, text.encode())
        os.lseek(fd, 0, os.SEEK_SET)
        return f"/proc/{os.getpid()}/fd/{fd}", fd, False
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(text)
        return f.name, None, True


def _external_cut(ffmpeg_bin: str, output_path: str, list_text: str,
                  cpus: set[int] | None = None) -> None:
    """Reference-exact external command over a concat list memfd.

    ``list_text`` is the exact concat-list bytes (oracle.concat_list —
    the declared byte-parity surface); it may be empty, in which case
    ffmpeg runs and fails just like the reference's empty-list run.

    When a cut cpuset is configured the child is confined by pinning the
    CALLING THREAD around the spawn: fork/exec children inherit the
    spawning thread's affinity mask, so this lands the same
    sched_setaffinity `taskset -c <list>` makes in the reference
    (pipeline.cpp:500-515) — without a preexec_fn, which the subprocess
    docs flag as deadlock-prone in threaded processes (the batch daemon
    spawns cuts while decode threads are live).
    """
    list_path, fd, unlink = _concat_list_fd(list_text)
    try:
        cmd = [
            ffmpeg_bin, "-y", "-hide_banner", "-loglevel", "error",
            "-f", "concat", "-safe", "0",
            "-protocol_whitelist", "file,pipe,fd",
            "-i", list_path,
            "-c", "copy", "-fflags", "+genpts",
            "-avoid_negative_ts", "make_zero",
            "-movflags", "+faststart",
            output_path,
        ]
        with _thread_affinity(cpus):
            res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"ffmpeg exited {res.returncode}: {res.stderr.strip()[:500]}")
    finally:
        if fd is not None:
            os.close(fd)
        if unlink:
            os.unlink(list_path)


class CutQueue:
    """Producer-consumer cut queue with one consumer thread.

    Scanning streams push jobs; a single worker drains them sequentially so
    disk writes never contend with each other (the reference's FFmpegQueue
    + ffmpeg_worker, batch_processor.cpp:138-150).
    """

    def __init__(self, cfg: Config | None = None):
        self.cfg = cfg or Config.from_env()
        self._q: queue.Queue[CutJob | None] = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="cut-worker")
        self._jobs_done = 0
        self._failures = 0
        self._worker.start()

    def push(self, job: CutJob) -> None:
        self._q.put(job)

    def _run(self) -> None:
        log.info("[Cut Worker] Started")
        while True:
            job = self._q.get()
            if job is None:
                break
            log.info(f"[Cut Worker] Processing job from stream "
                     f"{job.stream_id}: {os.path.basename(job.output_path)}")
            rc = execute_cut(job.input_path, job.output_path, job.segments,
                             job.stream_id, self.cfg)
            self._jobs_done += 1
            if rc != 0:
                self._failures += 1
        log.info(f"[Cut Worker] Finished ({self._jobs_done} jobs)")

    def finish(self) -> int:
        """Signal no more jobs, wait for drain; returns #failures."""
        self._q.put(None)
        self._worker.join()
        return self._failures
