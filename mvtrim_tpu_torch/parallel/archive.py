"""Sharded streaming scan for very long archives.

The counterpart of ``mvtrim_tpu/parallel/archive.py``.  One video's
timeline is chunk-decoded by host workers (the pipeline's task-queue
model), and the feeder packs their frames into global batches of
``frames_per_device`` rows per 'data' shard of the mesh; each shard is
decided on its own device (``parallel/mesh.py``) and the decisions come
back in feed order.  Segmentation stays on the host in float64, so the
segments are the single-file pipeline's.

Two payloads: ``bits`` (the packed MV activity masks, decided by the
word-domain kernel) and ``sad`` (decoded luma, decided by the block-SAD
and cluster-map kernels, for MV-less streams); ``auto`` probes the stream
for MV side data.  A JSON-lines sidecar (``ScanCheckpoint``) records each
chunk as its last frame is decided, so an interrupted scan resumes at
chunk granularity; its records and identity header are the JAX package's,
so a sidecar written by either package resumes in the other.

``scan_archive`` and ``scan_archive_multiprocess`` take a path; their
bodies, ``scan_archive_reader`` and ``scan_archive_multiprocess_reader``,
take ``open_reader()``, which opens one reader (a ``native.VideoReader``,
or anything with its ``duration``, ``fps``, ``width``, ``height``,
``scan_bits``, ``scan_luma`` and ``close``) per decode worker.
"""

from __future__ import annotations

import functools
import json
import math
import os
import queue
import threading

import numpy as np

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry, ScanTask
from ..io import native
from ..utils import logging as log
from ..utils import system
from . import distributed
from .mesh import (backend_device, build_mesh, build_process_mesh,
                   sharded_bits_scan_step, sharded_sad_scan_step)


class ScanCheckpoint:
    """Chunk-granular resume state for long archive scans.

    JSON-lines sidecar: one record per completed chunk with its motion
    timestamps.  A re-run skips completed chunks and seeds their
    timestamps — the mid-video resume the reference lacks (its only
    idempotency is the output-exists skip, batch_processor.cpp:66-69).
    """

    def __init__(self, path: str, identity: dict | None = None):
        self.path = path
        self.done: dict[int, list[float]] = {}
        seen_header = False
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        # a kill mid-append leaves one truncated line;
                        # tolerating it costs one chunk re-scan — far
                        # better than refusing the resume the sidecar
                        # exists to provide
                        continue
                    if "header" in rec:
                        seen_header = True
                        if identity is not None and \
                                rec["header"] != identity:
                            raise RuntimeError(
                                f"checkpoint {path} belongs to a "
                                f"different scan: sidecar header "
                                f"{rec['header']!r} != current "
                                f"{identity!r}; delete the file (or "
                                f"point MVT_CHECKPOINT elsewhere) to "
                                f"start fresh")
                        continue
                    self.done[int(rec["chunk"])] = rec["motion_ts"]
            if identity is not None and not seen_header and self.done:
                log.warn(f"checkpoint {path} has no identity header "
                         "(older format): cannot verify it matches this "
                         "video/config — resuming anyway")
        if identity is not None and not seen_header and not self.done:
            # stamp FRESH sidecars so a future resume against a different
            # video or config fails loudly instead of silently merging
            # foreign chunks.  Legacy headerless sidecars that already
            # carry chunk records are deliberately NOT stamped: stamping
            # would convert "cannot verify" into "verified" for records
            # this scan never checked — they keep warning on every resume
            with open(path, "a") as f:
                f.write(json.dumps({"header": identity}) + "\n")

    def record(self, chunk_id: int, motion_ts: list[float]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(
                {"chunk": chunk_id, "motion_ts": motion_ts}) + "\n")
        self.done[chunk_id] = motion_ts


def _identity(name: str, duration: float, cfg: Config, frame_skip: int,
              payload: str) -> dict:
    """Everything that shapes per-chunk motion timestamps or chunk ids: a
    sidecar written under any other value must not be resumed from.  The
    JAX package's headers exactly (the bits identity is its round-4 shape;
    the sad identity swaps the MV-only knobs for the SAD ones and carries a
    payload marker)."""
    if payload == "sad":
        return {
            "input": name,
            "duration": round(duration, 6),
            "chunk_duration_sec": cfg.chunk_duration_sec,
            "payload": "sad",
            "sad_threshold": cfg.sad_threshold,
            "block_size": cfg.block_size,
            "clusters_needed": cfg.clusters_needed,
            "vertical_mask": cfg.vertical_mask,
            "frame_skip": frame_skip,
        }
    return {
        "input": name,
        "duration": round(duration, 6),
        "chunk_duration_sec": cfg.chunk_duration_sec,
        "mv_threshold_sq": cfg.mv_threshold_sq,
        "block_shift": cfg.block_shift,
        "vectors_needed": cfg.vectors_needed,
        "clusters_needed": cfg.clusters_needed,
        "vertical_mask": cfg.vertical_mask,
        "frame_skip": frame_skip,
    }


def _scan_bits(reader, cfg: Config, geom: GridGeometry, frame_skip: int,
               start: float, end: float, max_frames: int, timing,
               resume: bool = False):
    return reader.scan_bits(
        start, end, threshold_sq=cfg.mv_threshold_sq,
        block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
        y_min=geom.y_min, y_max=geom.y_max,
        vectors_needed=cfg.vectors_needed, frame_skip=frame_skip,
        max_frames=max_frames, timing=timing, resume=resume)


def scan_archive_multiprocess(input_path: str, cfg: Config | None = None,
                              **kw):
    """``scan_archive_multiprocess_reader`` over the video at
    ``input_path``."""
    return scan_archive_multiprocess_reader(
        functools.partial(native.VideoReader, input_path), cfg,
        name=os.path.abspath(input_path), **kw)


def scan_archive_multiprocess_reader(open_reader, cfg: Config | None = None,
                                     *, name: str, mesh=None,
                                     frames_per_device: int = 256,
                                     checkpoint: str | None = None,
                                     progress_cb=None):
    """Multi-process archive scan of the packed-bits payload.

    Each rank decodes a DISJOINT chunk slice of the timeline (chunk_id %
    world == rank), decides its own rows on its own mesh (default:
    ``build_process_mesh``, its card, or the CPU for the CPU build of
    ``cfg``) and meets the other ranks only in host
    collectives: the agreed dispatch count, one motion count a dispatch
    (``stats['motion_frames_psum']``), and a final bit-exact float64
    timestamp gather, so that every rank runs the same host segmentation
    and returns the same (segments, duration, stats).

    Requires ``parallel.distributed.initialize()`` to have joined two or
    more ranks.  Every rank runs the same number of dispatches, ranks
    with no frames left included, so every collective has all ranks.

    ``checkpoint`` is a sidecar BASE path: each rank appends its chunk
    records to ``<base>.p<rank>``, whose identity header pins
    (process_count, process_index); a restart with another world size
    re-shards the chunks and REFUSES the sidecar.  ``progress_cb(i,
    n_dispatch)`` fires after each dispatch.
    """
    cfg = cfg or Config.from_env()
    pc, pi = distributed.world()
    if pc < 2:
        raise RuntimeError(
            "scan_archive_multiprocess needs a process group of two or more "
            "ranks (parallel.distributed.initialize); use scan_archive for "
            "single-process scans")
    mesh = mesh or build_process_mesh(backend_device(cfg))
    if mesh.shape["sweep"] != 1:
        raise RuntimeError(
            f"scan_archive_multiprocess needs a sweep=1 mesh, got "
            f"{mesh.shape}")
    local_rows = frames_per_device * mesh.shape["data"]

    reader = open_reader()
    try:
        duration, fps = reader.duration, reader.fps
        geom = GridGeometry.build(reader.width, reader.height, cfg)
        frame_skip = cfg.frame_skip(fps)

        ckpt = None
        resumed_ts: list[float] = []
        resumed_chunks = 0
        if checkpoint:
            identity = _identity(name, duration, cfg, frame_skip, "bits")
            identity.update(process_count=pc, process_index=pi)
            refusal = None
            try:
                ckpt = ScanCheckpoint(f"{checkpoint}.p{pi}", identity)
            except (RuntimeError, OSError) as e:
                refusal = e
            # every rank learns of a refusal before the scan's first
            # collective: a rank that went on alone would wait there for
            # ranks that have left, up to the group's timeout
            refused = distributed.allgather_ints(
                [refusal is not None]).ravel()
            if refusal is not None:
                raise refusal
            if refused.any():
                raise RuntimeError(
                    f"checkpoint {checkpoint}: rank(s) "
                    f"{np.flatnonzero(refused).tolist()} refused their "
                    f"sidecars (a different scan); rank {pi} stops with "
                    f"them")

        # --- decode this rank's disjoint chunk slice (cap-resume like
        # the single-process workers) ---
        max_frames = int(math.ceil(cfg.chunk_duration_sec
                                   * max(fps, 1.0))) + 64
        parts_bits: list[np.ndarray] = []
        parts_pts: list[np.ndarray] = []
        chunk_rows: list[tuple[int, int]] = []  # (cid, frames), feed order
        timing = native.ScanTiming()
        t, cid = 0.0, 0
        while t < duration:
            end = min(t + cfg.chunk_duration_sec, duration)
            if cid % pc == pi:
                if ckpt is not None and cid in ckpt.done:
                    resumed_ts.extend(ckpt.done[cid])
                    resumed_chunks += 1
                else:
                    n_chunk = 0
                    resume = False
                    while True:
                        bits, pts = _scan_bits(reader, cfg, geom,
                                               frame_skip, t, end,
                                               max_frames, timing, resume)
                        if len(pts) == 0:
                            break
                        parts_bits.append(bits)
                        parts_pts.append(pts)
                        n_chunk += len(pts)
                        if len(pts) < max_frames:
                            break
                        resume = True
                    if n_chunk == 0 and ckpt is not None:
                        ckpt.record(cid, [])   # empty chunk: done already
                    elif n_chunk:
                        chunk_rows.append((cid, n_chunk))
            cid += 1
            t += cfg.chunk_duration_sec
    finally:
        reader.close()
    local_bits = (np.concatenate(parts_bits) if parts_bits else
                  np.zeros((0, geom.gh, (geom.gw + 7) // 8), np.uint8))
    local_pts = (np.concatenate(parts_pts) if parts_pts
                 else np.zeros((0,), np.float64))
    n_frames = len(local_pts)

    # --- the dispatch count every rank agrees on: the most any rank
    # needs (frame counts differ per rank, chunk contents being data) ---
    sizes = distributed.allgather_ints(
        [n_frames, local_rows, mesh.shape["data"]])
    n_dispatch = max(-(-int(n) // int(r)) for n, r, _ in sizes)

    step = sharded_bits_scan_step(geom, cfg, mesh)
    motion_ts: list[float] = list(resumed_ts)
    motion_frames_psum = 0
    # chunk attribution for checkpointing: local row extents per chunk
    # (feed order), drained as dispatches cover them — a chunk records
    # the moment its last row has been decided, so a killed job loses at
    # most the in-flight dispatch's chunks
    chunk_bounds: list[tuple[int, int, int]] = []    # (cid, row_lo, n)
    row = 0
    for cid_, n_ in chunk_rows:
        chunk_bounds.append((cid_, row, n_))
        row += n_
    chunk_left = {cid_: n_ for cid_, n_ in chunk_rows}
    chunk_motion: dict[int, list[float]] = {cid_: [] for cid_, _ in
                                            chunk_rows}
    for i in range(n_dispatch):
        lo = i * local_rows
        n_valid = max(0, min(lo + local_rows, n_frames) - lo)
        count = 0
        if n_valid:
            mine, count = step(local_bits[lo:lo + n_valid])
            motion_ts.extend(local_pts[lo:lo + n_valid][mine].tolist())
            for cid_, clo, n_ in chunk_bounds:
                if clo >= lo + n_valid:
                    break                     # rows not yet dispatched
                if cid_ not in chunk_left:
                    continue                  # completed earlier
                a, b = max(clo, lo), min(clo + n_, lo + n_valid)
                if a >= b:
                    continue
                chunk_motion[cid_].extend(
                    local_pts[a:b][mine[a - lo:b - lo]].tolist())
                chunk_left[cid_] -= b - a
                if chunk_left[cid_] == 0:
                    del chunk_left[cid_]
                    done_ts = chunk_motion.pop(cid_)
                    if ckpt is not None:
                        ckpt.record(cid_, done_ts)
        motion_frames_psum += distributed.allreduce_sum(count)
        if progress_cb is not None:
            progress_cb(i, n_dispatch)

    # --- bit-exact global timestamp merge -> the same host segmentation
    # on every rank ---
    nms = distributed.allgather_ints([len(motion_ts)]).ravel()
    buf = np.zeros((max(1, int(nms.max())),), np.float64)
    buf[:len(motion_ts)] = motion_ts
    gathered = distributed.allgather_f64(buf)              # [pc, maxn]
    all_ts = np.concatenate([gathered[p, :int(nms[p])] for p in range(pc)])
    timestamps = oracle.merge_timestamps(all_ts.tolist())
    segments = oracle.segments_from_timestamps(
        timestamps, max_gap_sec=cfg.max_gap_sec,
        padding_sec=cfg.padding_sec, duration=duration)
    data_size = int(sizes[:, 2].sum())
    stats = {
        "frames_scanned": int(sizes[:, 0].sum()),
        "frames_with_mvs_local": timing.frames_with_mvs,
        "motion_frames": int(timestamps.size),
        "motion_frames_psum": motion_frames_psum,
        "dispatches": n_dispatch,
        "mesh": {"data": data_size, "sweep": 1},
        "processes": pc,
        "global_batch": int(sizes[:, 1].sum()),
        "resumed_chunks_local": resumed_chunks,
    }
    log.info(f"archive scan: {stats['frames_scanned']} frames over {pc} "
             f"ranks x mesh {stats['mesh']} in {n_dispatch} dispatches")
    return segments, duration, stats


def _probe_archive_mvs(open_reader, cfg: Config, geom: GridGeometry,
                       frame_skip: int) -> bool:
    """Cheap MV-capability probe for payload='auto': scan short chunk
    prefixes from the start until at least one frame is analyzed (up to
    3 non-empty chunks) and report whether any carried MV side data.

    MV export is a stream/codec property, not content: intra-only
    streams and HEVC on FFmpeg < 7 export none for ANY frame (the
    reference detects nothing on them, motion_scanner.cpp:219-221) — so a
    short prefix decides it.  A wrong 'sad' answer still detects motion
    correctly, just via the pixel path.
    """
    reader = open_reader()
    try:
        timing = native.ScanTiming()
        t, probed = 0.0, 0
        while t < reader.duration and probed < 3:
            end = min(t + cfg.chunk_duration_sec, reader.duration)
            _, pts = _scan_bits(reader, cfg, geom, frame_skip, t, end, 64,
                                timing)
            if timing.frames_with_mvs > 0:
                return True
            if len(pts) > 0:
                probed += 1
            t += cfg.chunk_duration_sec
        return timing.frames_with_mvs > 0
    finally:
        reader.close()


def scan_archive(input_path: str, cfg: Config | None = None, **kw):
    """``scan_archive_reader`` over the video at ``input_path``."""
    return scan_archive_reader(
        functools.partial(native.VideoReader, input_path), cfg,
        name=os.path.abspath(input_path), **kw)


def scan_archive_reader(open_reader, cfg: Config | None = None, *,
                        name: str, mesh=None, decode_workers: int = 0,
                        frames_per_device: int = 256,
                        checkpoint: str | None = None,
                        payload: str | None = None):
    """Scan one (long) video over a device mesh.

    Returns (segments, duration, stats dict).  Segments come from the
    host float64 oracle path over the motion timestamps, so they are
    identical to the single-file pipeline's.  The mesh defaults to every
    card, or one CPU shard for the CPU build of ``cfg``.  With ``checkpoint``, a
    sidecar file records per-chunk results so interrupted scans resume.
    ``name`` is the video's name in the sidecar's identity (the absolute
    path, for ``scan_archive``).

    ``payload`` picks the scan domain, defaulting to ``cfg.pipeline_mode``
    (MVT_PIPELINE: mv -> bits, sad -> sad, else auto):

    * ``'bits'`` — packed MV activity masks (mvt_scan_bits), decided by
      ``sharded_bits_scan_step``;
    * ``'sad'``  — decoded luma through ``sharded_sad_scan_step``, for
      intra-only / MV-less archives.  Decisions match the single-file SAD
      pipeline: each shard's window carries the frame before it, so
      consecutive diffs cross shard and batch boundaries, and a chunk's
      first analyzed frame is never motion (SADDetector contract);
    * ``'auto'`` — probe the stream prefix for MV side data
      (``_probe_archive_mvs``) and pick bits or sad.

    Sidecars are payload-specific (the identity header carries the payload
    and its decision-shaping knobs).
    """
    cfg = cfg or Config.from_env()
    mesh = mesh or build_mesh(device=backend_device(cfg))
    data_size = mesh.shape["data"]

    with open_reader() as reader:
        duration, fps = reader.duration, reader.fps
        width, height = reader.width, reader.height
    geom = GridGeometry.build(width, height, cfg)
    frame_skip = cfg.frame_skip(fps)

    if payload is None:
        payload = {"mv": "bits", "sad": "sad"}.get(cfg.pipeline_mode,
                                                   "auto")
    if payload not in ("auto", "bits", "sad"):
        raise ValueError(f"unknown archive payload {payload!r} "
                         "(bits | sad | auto)")
    if payload == "auto":
        payload = ("bits" if _probe_archive_mvs(open_reader, cfg, geom,
                                                frame_skip) else "sad")
        log.info(f"archive payload auto-selected: {payload}"
                 + ("" if payload == "bits"
                    else " (no MV side data in the stream prefix)"))

    ckpt = (ScanCheckpoint(checkpoint, _identity(name, duration, cfg,
                                                 frame_skip, payload))
            if checkpoint else None)

    if payload == "sad":
        # luma is H*W bytes a frame (~2 MB at 1080p): cap the host staging
        # buffer at ~256 MB, like the pipeline's SAD branch caps its
        # decode windows
        frames_per_device = max(4, min(
            frames_per_device,
            (256 << 20) // max(1, width * height) // max(1, data_size)))
        step = sharded_sad_scan_step(geom, cfg, mesh)
    else:
        step = sharded_bits_scan_step(geom, cfg, mesh)
    global_batch = frames_per_device * data_size

    # --- host decode workers over the chunked timeline, sized by the
    # cgroup-aware CPU budget (decode is host-CPU-bound), not by the
    # device count ---
    n_workers = decode_workers or max(2, min(8, system.detect_cpu_limit()))
    num_chunks = max(1, math.ceil(duration / cfg.chunk_duration_sec))
    n_workers = min(n_workers, num_chunks)
    tasks: queue.Queue = queue.Queue()
    resumed_ts: list[float] = []
    resumed_chunks = 0
    t = 0.0
    cid = 0
    while t < duration:
        if ckpt is not None and cid in ckpt.done:
            resumed_ts.extend(ckpt.done[cid])
            resumed_chunks += 1
        else:
            tasks.put(ScanTask(
                t, min(t + cfg.chunk_duration_sec, duration), cid))
        cid += 1
        t += cfg.chunk_duration_sec
    for _ in range(n_workers):
        tasks.put(None)

    results: queue.Queue = queue.Queue(maxsize=2 * n_workers)
    max_frames = int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64
    timings = [native.ScanTiming() for _ in range(n_workers)]
    errors: list[Exception] = []

    if payload == "sad":
        # luma sub-scans are H*W bytes a frame: cap each call like the
        # pipeline's SAD branch; parts stream through the feeder as they
        # decode, so a 30 s 1080p chunk never sits in memory whole
        if cfg.chunk_frames_cap > 0:
            part_cap = cfg.chunk_frames_cap
        else:
            part_cap = max(16, (256 << 20) // max(1, width * height)
                           // max(1, n_workers))
        max_frames = min(max_frames, part_cap)

    def scan_chunk(r, widx, start, end, resume):
        if payload == "sad":
            return r.scan_luma(start, end, frame_skip=frame_skip,
                               max_frames=max_frames,
                               timing=timings[widx], resume=resume)
        return _scan_bits(r, cfg, geom, frame_skip, start, end, max_frames,
                          timings[widx], resume)

    def worker(widx: int):
        try:
            r = open_reader()
            while True:
                task = tasks.get()
                if task is None:
                    break
                # resume past the frame cap, streaming each sub-scan to
                # the feeder as a PART: (chunk_id, data, pts, first, last,
                # carry).  resume=True continues decode from the exact
                # stream position with the skip counter carried, keeping
                # the analyzed frame set of an uncapped chunk scan; the
                # chunk stays one checkpoint unit through the feeder's
                # first/last accounting.  A part emits even when empty: an
                # empty first part is an empty chunk, an empty later part
                # closes the chunk's accounting.
                resume = False
                first = True
                carry = None
                while True:
                    data, pts = scan_chunk(r, widx, task.start, task.end,
                                           resume)
                    last = len(pts) < max_frames
                    results.put((task.chunk_id, data, pts, first, last,
                                 carry))
                    if last:
                        break
                    # the part's last analyzed frame is the next part's
                    # predecessor (sad payload); bits parts need no carry
                    carry = (data[-1].copy() if payload == "sad"
                             else None)
                    first = False
                    resume = True
            r.close()
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            results.put(None)

    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"archive-{i}")
               for i in range(n_workers)]
    for th in threads:
        th.start()

    # --- feeder: pack frames into global batches ---
    if payload == "sad":
        # row 0 is the frame fed just before row 1 (the last row of the
        # previous batch), so each shard's window [its carry, its frames]
        # is a view of this one buffer; valid is False at chunk starts and
        # placeholder rows
        buf = np.zeros((1 + global_batch, height, width), np.uint8)
        valid = np.ones((global_batch,), bool)
    else:
        buf = np.zeros((global_batch, geom.gh, (geom.gw + 7) // 8),
                       np.uint8)
    lead = 1 if payload == "sad" else 0   # buffer row of feed row 0
    buf_pts = np.zeros((global_batch,), np.float64)
    fill = 0
    motion_ts: list[float] = list(resumed_ts)
    frames_scanned = 0
    dispatches = 0
    # chunk attribution for checkpointing: spans of the current buffer
    # belonging to each chunk, plus per-chunk completion accounting.  A
    # chunk completes when its last part has been seen (not in
    # chunk_open) AND all its fed frames have flushed (chunk_left == 0).
    spans: list[tuple[int, int, int]] = []        # (chunk_id, buf_lo, n)
    chunk_left: dict[int, int] = {}
    chunk_motion: dict[int, list[float]] = {}
    chunk_open: set[int] = set()
    tail_cid = -1   # chunk id owning the most recently fed buffer row

    def maybe_complete(cid):
        if cid not in chunk_open and chunk_left.get(cid) == 0:
            # pop even without a checkpoint: the dict would otherwise
            # retain a second copy of every motion timestamp for the
            # whole (possibly days-long) scan
            del chunk_left[cid]
            done_ts = chunk_motion.pop(cid)
            if ckpt is not None:
                ckpt.record(cid, done_ts)

    def flush(n_valid: int):
        nonlocal dispatches
        if errors:
            spans.clear()
            return
        if n_valid == 0:
            return
        dispatches += 1
        try:
            if payload == "sad":
                m, _ = step(buf[:1 + n_valid], valid[:n_valid])
            else:
                m, _ = step(buf[:n_valid])
            motion_ts.extend(buf_pts[:n_valid][m].tolist())
            for cid, lo, n in spans:
                chunk_motion[cid].extend(
                    buf_pts[lo:lo + n][m[lo:lo + n]].tolist())
                chunk_left[cid] -= n
                maybe_complete(cid)
            if payload == "sad":
                buf[0] = buf[n_valid]   # the next batch's predecessor
                valid[:] = True
        except Exception as e:  # noqa: BLE001 — drain workers, raise after
            errors.append(e)
        spans.clear()

    done = 0
    while done < n_workers:
        item = results.get()
        if item is None:
            done += 1
            continue
        if errors:
            continue  # drain only
        cid, data, pts, first_part, last_part, carry = item
        frames_scanned += len(pts)
        if first_part:
            chunk_left[cid] = 0
            chunk_motion[cid] = []
            chunk_open.add(cid)
        if last_part:
            chunk_open.discard(cid)
        if len(pts) == 0:
            # empty chunk, or the empty closing part of a capped chunk
            maybe_complete(cid)
            continue
        chunk_left[cid] += len(pts)
        if carry is not None and tail_cid != cid:
            # continuation part whose predecessor is NOT the row fed just
            # before it (another chunk's part interleaved): inject the
            # shipped carry as a placeholder row — decided never (valid
            # False), attributed to no span — purely so the next row's
            # predecessor is the right frame
            if fill == global_batch:
                flush(global_batch)
                fill = 0
            buf[lead + fill] = carry
            valid[fill] = False
            fill += 1
        off = 0
        while off < len(pts):
            take = min(global_batch - fill, len(pts) - off)
            buf[lead + fill:lead + fill + take] = data[off:off + take]
            if payload == "sad" and first_part and off == 0:
                # the chunk's first analyzed frame has no predecessor and
                # is never motion (SADDetector contract)
                valid[fill] = False
            buf_pts[fill:fill + take] = pts[off:off + take]
            spans.append((cid, fill, take))
            fill += take
            off += take
            tail_cid = cid
            if fill == global_batch:
                flush(global_batch)
                fill = 0
    flush(fill)

    for th in threads:
        th.join()
    if errors:
        raise RuntimeError(errors[0])

    frames_with_mvs = sum(t.frames_with_mvs for t in timings)
    if payload == "bits" and frames_scanned and not frames_with_mvs:
        # payload='auto' (the default) routes such streams to the SAD
        # payload up front; this can only trigger when a caller FORCED
        # bits (MVT_PIPELINE=mv) on an MV-less stream — stay loud rather
        # than silently report a motionless archive
        log.warn(
            f"none of the {frames_scanned} scanned frames carried MV "
            "side data (intra-only stream, or a codec this FFmpeg "
            "cannot export MVs for — HEVC needs FFmpeg >= 7): the "
            "forced bits payload cannot detect motion on this input; "
            "use MVT_PIPELINE=sad (payload='sad') or the auto default")
    timestamps = oracle.merge_timestamps(motion_ts)
    segments = oracle.segments_from_timestamps(
        timestamps, max_gap_sec=cfg.max_gap_sec,
        padding_sec=cfg.padding_sec, duration=duration)
    stats = {
        "frames_scanned": frames_scanned,
        "frames_with_mvs": frames_with_mvs,
        "motion_frames": int(timestamps.size),
        "dispatches": dispatches,
        "payload": payload,
        "mesh": dict(mesh.shape),
        "global_batch": global_batch,
        "resumed_chunks": resumed_chunks,
        # summed across decode workers (wall-clock overlaps) — the
        # seek/decode/analyze split the pipeline's phase tree reports
        "worker_us": {
            "seek": sum(t.seek_us for t in timings),
            "decode": sum(t.decode_us for t in timings),
            "analyze": sum(t.analyze_us for t in timings),
        },
    }
    log.info(f"archive scan ({payload}): {frames_scanned} frames over "
             f"mesh {dict(mesh.shape)} in {dispatches} dispatches")
    return segments, duration, stats
