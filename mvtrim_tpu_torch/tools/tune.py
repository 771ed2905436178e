"""tune — sweep detector configs over one decode of a video.

The counterpart of ``mvtrim_tpu/tools/tune.py``.  Scans the clip once and
scores every (MV_THRESHOLD_SQ, VECTORS_NEEDED, CLUSTERS_NEEDED)
combination, reporting motion frames, segment count and savings per
config.  The payload (``--scan-input``):

* ``grids``  — the native layer scatters one vote grid per threshold
  during decode (mvt_scan_grids_multi); the vote sweep runs the
  cluster-map kernel per (vectors, clusters) pair;
* ``mv_raw`` — raw MV fields, exported once; the raw-MV sweep runs the
  fused raw-MV kernel per (threshold, vectors, clusters) triple;
* ``sad``    — decoded luma; one block-SAD grid per window, then the
  cluster-map kernel per (sad_threshold, clusters) pair.

``--device-stats`` keeps the motion columns on the device and ends in one
segmentation call per threshold (ops/segmentation.py, float32); without it
each batch's motion comes back and the float64 oracle segments it, as a
pipeline run at that config would.  The device is the card
(``MVT_SCAN_BACKEND=auto``) unless the backend asks for the CPU build
(``torch`` or ``oracle``).  The grids and SAD routes score through a
device mesh (``parallel/mesh.py``): one device unless ``--mesh N
[--mesh-sweep S]`` asks for N, frames over its 'data' axis, configs over
its 'sweep' axis; the rows are the same.

Usage:
  python -m mvtrim_tpu_torch.tools.tune input.mp4 \\
      [--thresholds 4,16,64] [--vectors 1,2,4] [--clusters 1,2,4] \\
      [--scan-input grids|mv_raw|sad] [--device-stats] \\
      [--mesh N [--mesh-sweep S]]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from ..core import oracle
from ..core.config import Config
from ..core.types import GridGeometry
from ..io import native
from ..models.staging import resolve_backend
from ..ops.mv_vote import threshold_bound
from ..ops.sad import sad_threshold_sum
from ..ops.segmentation import segment_op
from ..ops.sweep import mv_sweep_op
from ..parallel.mesh import (Staging, build_mesh, sharded_sad_sweep_step,
                             sharded_scan_step)


def _device(cfg: Config) -> torch.device:
    backend = resolve_backend(cfg.scan_backend)
    return torch.device("cuda" if backend == "cuda" else "cpu")


def sweep(input_path: str, thresholds, vectors, clusters,
          **kw) -> list[dict]:
    """``sweep_reader`` over one decode of the clip at ``input_path``."""
    with native.VideoReader(input_path) as reader:
        return sweep_reader(reader, thresholds, vectors, clusters, **kw)


def sweep_reader(reader, thresholds, vectors, clusters, *,
                 cfg: Config | None = None, batch_frames: int = 512,
                 device_stats: bool = False,
                 scan_input: str = "grids", mesh=None) -> list[dict]:
    """Score every config combination over one decode of ``reader`` (an
    open ``native.VideoReader``, or anything with its ``duration``,
    ``fps``, ``width``, ``height`` and scan methods).

    ``device_stats=False`` (default): per-batch motion comes back to the
    host and segmentation/savings run through the float64 oracle — exact
    with what a pipeline run at that config would decide.
    ``device_stats=True``: motion stays on the device for the whole scan
    and one segmentation call per threshold produces the stats table;
    timestamps are float32 there, so savings can differ from the oracle in
    the last decimals.

    ``scan_input`` 'grids' scatters one vote grid per threshold during
    decode; 'mv_raw' exports raw MV fields once and sweeps the magnitude
    thresholds as device data.  Identical decisions either way.

    The grids route scores on ``mesh`` (``parallel.mesh.build_mesh``;
    default one device of the backend): each batch's frames split over
    'data', the (vectors, clusters) pairs over 'sweep'
    (``sharded_scan_step``); the decisions are the single-device ones.
    The mv_raw route takes no mesh.
    """
    cfg = cfg or Config.from_env()
    device = _device(cfg)
    thresholds = list(thresholds)
    vc_pairs = [(v, c) for v in vectors for c in clusters]
    # the reference stores VECTORS_NEEDED as uint8 (config.hpp:74) and
    # Config.__post_init__ wraps to match; sweeping the raw value would
    # score configs the reference cannot express (256 vs 0, -1 vs 255)
    vec_needs = np.asarray([v & 0xFF for v, _ in vc_pairs], np.int32)
    clust_needs = np.asarray([c for _, c in vc_pairs], np.int32)
    # effective vec == 0: zero votes satisfy >= 0, but the reference
    # still decides MV-less frames False before phase 2 runs
    # (motion_scanner.cpp:219-221) — those frames need masking because
    # a zero vote grid cannot carry the distinction
    vec0 = vec_needs == 0

    duration, fps = reader.duration, reader.fps
    geom = GridGeometry.build(reader.width, reader.height, cfg)
    frame_skip = cfg.frame_skip(fps)

    # motion_ts[(threshold index, vc index)] -> timestamps (host path)
    motion_ts: dict[tuple[int, int], list[float]] = {
        (ti, vi): [] for ti in range(len(thresholds))
        for vi in range(len(vc_pairs))
    }
    # device path: per-threshold lists of motion [n, K] on the device
    dev_motion: list[list] = [[] for _ in thresholds]
    all_pts: list[np.ndarray] = []

    if scan_input == "mv_raw":
        if mesh is not None:
            raise ValueError("--mesh supports the grids scan input only")
        _sweep_mv_raw(reader, cfg, geom, thresholds, vc_pairs, frame_skip,
                      batch_frames, device_stats, motion_ts, dev_motion,
                      all_pts, Staging(device))
    else:
        mesh = mesh or build_mesh(1, device=device.type)
        device = mesh.devices[0, 0]   # where the step leaves its motion
        staging = Staging(device)
        step = sharded_scan_step(geom, cfg, mesh, sweep_clusters=True)
        cap = int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64
        cur = native.ChunkScanCursor(duration, cfg.chunk_duration_sec, cap)
        while cur.more():
            start, end = cur.window()
            grids, pts, has_mv = reader.scan_grids_multi(
                start, end, thresholds_sq=thresholds,
                block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
                y_min=geom.y_min, y_max=geom.y_max,
                frame_skip=frame_skip, max_frames=cap, resume=cur.resume)
            cur.advance(len(pts))
            if len(pts) == 0:
                continue
            if device_stats:
                all_pts.append(pts)
            for lo in range(0, len(pts), batch_frames):
                hi = min(lo + batch_frames, len(pts))
                allow = None
                if vec0.any():
                    # reference `!sd -> false` for the vec==0 columns
                    # (zero grids cannot represent "no side data")
                    (allow,) = staging.upload(
                        [has_mv[lo:hi, None] | ~vec0[None, :]])
                for ti in range(len(thresholds)):
                    motion = step(grids[lo:hi, ti], vec_needs,
                                  clust_needs)[0]
                    if allow is not None:
                        motion = motion & allow
                    if device_stats:
                        dev_motion[ti].append(motion)
                    else:
                        motion = motion.cpu().numpy()
                        for vi in range(len(vc_pairs)):
                            motion_ts[(ti, vi)].extend(
                                pts[lo:hi][motion[:, vi]].tolist())

    def make_row(ti, vi):
        vec, clu = vc_pairs[vi]
        return {"mv_threshold_sq": thresholds[ti],
                "vectors_needed": vec, "clusters_needed": clu}

    if device_stats:
        return _device_stats_rows(thresholds, len(vc_pairs), dev_motion,
                                  all_pts, duration, cfg, make_row, device)
    return _host_rows(thresholds, len(vc_pairs), motion_ts, duration,
                      cfg, make_row)


def _host_rows(thresholds, nvc, motion_ts, duration, cfg, make_row):
    """Exact (float64 oracle) stats table — shared by the MV routes and
    the SAD route; one definition so the routes cannot drift."""
    rows = []
    for ti in range(len(thresholds)):
        for vi in range(nvc):
            merged = oracle.merge_timestamps(motion_ts[(ti, vi)])
            segments = oracle.segments_from_timestamps(
                merged, max_gap_sec=cfg.max_gap_sec,
                padding_sec=cfg.padding_sec, duration=duration)
            _, saved_pct = oracle.savings(segments, duration)
            row = make_row(ti, vi)
            row.update(motion_frames=int(merged.size),
                       segments=len(segments),
                       saved_pct=round(saved_pct, 2))
            rows.append(row)
    return rows


def _device_stats_rows(thresholds, nvc, dev_motion, all_pts, duration,
                       cfg, make_row, device):
    """Device-resident stats tail (--device-stats): one segmentation call
    per threshold over its motion columns, which stayed on the device for
    the whole scan.  Shared by the MV and SAD routes."""
    # segment capacity: the gap rule bounds how many segments can fit
    max_segments = min(4096, int(duration /
                                 max(1e-6, cfg.max_gap_sec)) + 2)
    ts = torch.as_tensor(np.concatenate(all_pts) if all_pts
                         else np.zeros((1,)), dtype=torch.float32).to(device)
    rows = []
    for ti in range(len(thresholds)):
        if not dev_motion[ti]:
            count = kept = frames = np.zeros((nvc,))
        else:
            # [N, K], on the mesh's first device
            motion = torch.cat(dev_motion[ti], dim=0).to(device)
            _, _, count, kept = segment_op(
                ts, motion, duration, max_segments=max_segments,
                max_gap_sec=cfg.max_gap_sec, padding_sec=cfg.padding_sec)
            count, kept, frames = (x.cpu().numpy() for x in
                                   (count, kept, motion.sum(dim=0)))
        for vi in range(nvc):
            kept_s = float(kept[vi])
            saved = 100.0 * max(0.0, duration - kept_s) / duration \
                if duration > 0 else 0.0
            row = make_row(ti, vi)
            row.update(motion_frames=int(frames[vi]),
                       segments=int(count[vi]),
                       saved_pct=round(saved, 2), stats="device_f32")
            if int(count[vi]) >= max_segments:
                # capacity saturated: later segments were dropped, so
                # segments/saved_pct understate reality — mark the row
                # and tell the operator (host path has no cap)
                row["segments_saturated"] = True
                cfg_desc = " ".join(
                    f"{k}={v}" for k, v in make_row(ti, vi).items())
                print(f"tune: segment capacity {max_segments} "
                      f"saturated for {cfg_desc}; re-run without "
                      "--device-stats for exact stats", file=sys.stderr)
            rows.append(row)
    return rows


def sweep_sad(input_path: str, thresholds, clusters, **kw) -> list[dict]:
    """``sweep_sad_reader`` over one decode of the clip at ``input_path``."""
    with native.VideoReader(input_path) as reader:
        return sweep_sad_reader(reader, thresholds, clusters, **kw)


def sweep_sad_reader(reader, thresholds, clusters, *,
                     cfg: Config | None = None, batch_frames: int = 512,
                     device_stats: bool = False, mesh=None) -> list[dict]:
    """Score K (sad_threshold, clusters_needed) configs over ONE luma
    decode of ``reader`` — the pixel-domain analog of sweep_reader().

    Decisions are those of K independent SADDetector pipeline runs at each
    config: a chunk's first analyzed frame is never motion, the carry is
    threaded across cap-resumed sub-scans, and the SAD bound is the same
    integer.  ``thresholds`` are ``sad_threshold`` values (mean abs diff
    per pixel); a block is active iff its SAD sum clears the bound.

    The scoring runs on ``mesh`` like ``sweep_reader``'s: each window's
    frames split over 'data', each shard with the frame before it as its
    carry, the (threshold, clusters) configs over 'sweep'
    (``sharded_sad_sweep_step``).
    """
    cfg = cfg or Config.from_env()
    device = _device(cfg)
    thresholds = list(thresholds)
    clusters = list(clusters)
    nvc = len(clusters)
    bs = cfg.block_size
    # flattened config axis k = ti * nvc + vi (same layout as _sweep_mv_raw)
    bounds_k = np.asarray([sad_threshold_sum(t, bs)
                           for t in thresholds for _ in clusters], np.int64)
    clus_k = np.asarray([c for _ in thresholds for c in clusters], np.int32)

    duration, fps = reader.duration, reader.fps
    geom = GridGeometry.build(reader.width, reader.height, cfg)
    frame_skip = cfg.frame_skip(fps)
    mesh = mesh or build_mesh(1, device=device.type)
    device = mesh.devices[0, 0]   # where the step leaves its motion
    staging = Staging(device)
    step = sharded_sad_sweep_step(geom, cfg, mesh)

    motion_ts: dict[tuple[int, int], list[float]] = {
        (ti, vi): [] for ti in range(len(thresholds))
        for vi in range(nvc)}
    dev_motion: list[list] = [[] for _ in thresholds]
    all_pts: list[np.ndarray] = []

    # luma frames are H*W bytes: cap the per-call decode like the
    # pipeline's SAD branch
    if cfg.chunk_frames_cap > 0:
        mem_cap = cfg.chunk_frames_cap
    else:
        mem_cap = max(16, (512 << 20) // max(1, reader.width *
                                             reader.height))
    cap = min(mem_cap,
              int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64)
    cur = native.ChunkScanCursor(duration, cfg.chunk_duration_sec, cap)
    luma_carry = None  # last analyzed frame of the prior sub-scan
    while cur.more():
        start, end = cur.window()
        if not cur.resume:
            # chunks are independent by design (SADDetector contract):
            # a chunk's first analyzed frame has no predecessor
            luma_carry = None
        data, pts = reader.scan_luma(start, end, frame_skip=frame_skip,
                                     max_frames=cap, resume=cur.resume)
        cur.advance(len(pts))
        if len(pts) == 0:
            continue
        if device_stats:
            all_pts.append(pts)
        for lo in range(0, len(pts), batch_frames):
            hi = min(lo + batch_frames, len(pts))
            n = hi - lo
            # row 0 = predecessor.  At chunk start there is none: feed the
            # frame itself (diff 0) and force its row False below —
            # SADDetector's no-predecessor rule.  Cap-resumed sub-scans
            # and intra-scan batches diff against their real predecessor.
            mask_first = lo == 0 and luma_carry is None
            if lo > 0:
                prev = data[lo - 1]
            else:
                prev = data[0] if mask_first else luma_carry
            window = np.concatenate([prev[None], data[lo:hi]])
            motion = step(window, bounds_k, clus_k)
            if mask_first:
                allow = np.ones((n, len(clus_k)), bool)
                allow[0] = False
                motion = motion & staging.upload([allow])[0]
            if device_stats:
                for ti in range(len(thresholds)):
                    dev_motion[ti].append(motion[:, ti * nvc:(ti + 1) * nvc])
            else:
                mnp = motion.cpu().numpy()
                for ti in range(len(thresholds)):
                    for vi in range(nvc):
                        sel = mnp[:, ti * nvc + vi]
                        motion_ts[(ti, vi)].extend(
                            pts[lo:hi][sel].tolist())
        luma_carry = data[-1].copy()

    def make_row(ti, vi):
        return {"sad_threshold": thresholds[ti],
                "clusters_needed": clusters[vi]}

    if device_stats:
        return _device_stats_rows(thresholds, nvc, dev_motion, all_pts,
                                  duration, cfg, make_row, device)
    return _host_rows(thresholds, nvc, motion_ts, duration, cfg, make_row)


def _sweep_mv_raw(reader, cfg, geom, thresholds, vc_pairs, frame_skip,
                  batch_frames, device_stats, motion_ts, dev_motion,
                  all_pts, staging: Staging) -> None:
    """One raw-MV decode, all (threshold, vec, clu) combos on the device.

    Flattened config axis k = ti * len(vc_pairs) + vi; chunks whose MV
    count overflows MVT_MV_CAPACITY are re-decoded at a fitting capacity
    (exactness over speed — a truncated list is never scored).
    """
    nvc = len(vc_pairs)
    bounds = np.asarray([threshold_bound(t) for t in thresholds
                         for _ in vc_pairs], np.int64)
    # uint8 wrap: same rationale as sweep()'s vec_needs
    vecs = np.asarray([v & 0xFF for _ in thresholds for v, _ in vc_pairs],
                      np.int32)
    clus = np.asarray([c for _ in thresholds for _, c in vc_pairs],
                      np.int32)

    cap = int(math.ceil(cfg.chunk_duration_sec
                        * max(reader.fps, 1.0))) + 64
    cur = native.ChunkScanCursor(reader.duration, cfg.chunk_duration_sec,
                                 cap)
    capm = cfg.mv_capacity
    marks = None  # rollback point: the current chunk's list lengths
    while cur.more():
        start, end = cur.window()
        if not cur.resume:
            marks = (len(all_pts), [len(x) for x in dev_motion],
                     {k: len(v) for k, v in motion_ts.items()})
        mvs, counts, pts = reader.scan_mvs(
            start, end, frame_skip=frame_skip, max_frames=cap,
            max_mv=capm, resume=cur.resume)
        if len(pts) and (counts < 0).any():
            # MV-capacity overflow: roll back any partial contributions
            # this chunk already scored, then restart the whole chunk
            # from a fresh seek at a fitting capacity
            del all_pts[marks[0]:]
            for lst, n in zip(dev_motion, marks[1]):
                del lst[n:]
            for k, n in marks[2].items():
                del motion_ts[k][n:]
            capm = 1 << int(np.ceil(np.log2(-counts.min())))
            cur.restart_chunk()
            continue
        cur.advance(len(pts))
        if len(pts) == 0:
            continue
        if device_stats:
            all_pts.append(pts)
        for lo in range(0, len(pts), batch_frames):
            hi = min(lo + batch_frames, len(pts))
            fields, cnts = staging.upload([mvs[lo:hi], counts[lo:hi]])
            motion = mv_sweep_op(fields, cnts, geom, cfg.block_shift,
                                 bounds, vecs, clus)
            if device_stats:
                for ti in range(len(thresholds)):
                    dev_motion[ti].append(
                        motion[:, ti * nvc:(ti + 1) * nvc])
            else:
                mnp = motion.cpu().numpy()
                for ti in range(len(thresholds)):
                    for vi in range(nvc):
                        sel = mnp[:, ti * nvc + vi]
                        motion_ts[(ti, vi)].extend(
                            pts[lo:hi][sel].tolist())


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="tune")
    parser.add_argument("input")
    parser.add_argument("--thresholds", default=None,
                        help="comma list of MV_THRESHOLD_SQ values "
                             "(default 4,16,64), or SAD_THRESHOLD values "
                             "with --scan-input sad (default 4,12,30)")
    parser.add_argument("--vectors", default=None,
                        help="comma list of VECTORS_NEEDED values "
                             "(default 1,2,4; MV routes only — the SAD "
                             "path has no vote counts)")
    parser.add_argument("--clusters", default="1,2,4")
    parser.add_argument("--device-stats", action="store_true",
                        help="compute the stats table with the device "
                             "segmentation op (one host round trip; f32)")
    parser.add_argument("--scan-input", default="grids",
                        choices=("grids", "mv_raw", "sad"),
                        help="scan payload: per-threshold vote grids "
                             "(default), raw MV fields with on-device "
                             "threshold sweeping, or decoded luma through "
                             "the pixel-domain SAD path (sweeps "
                             "sad_threshold x clusters_needed)")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="shard the sweep over an N-device mesh: "
                             "frames over 'data', configs over 'sweep' "
                             "(grids and sad inputs; mv_raw is "
                             "single-device)")
    parser.add_argument("--mesh-sweep", type=int, default=0, metavar="S",
                        help="sweep-axis size of the mesh (default: the "
                             "largest divisor of N not exceeding the "
                             "config-pair count)")
    args = parser.parse_args(argv)

    clusters = [int(x) for x in args.clusters.split(",")]

    def make_mesh(n_configs):
        if not args.mesh:
            return None
        s = args.mesh_sweep or max(
            d for d in range(1, args.mesh + 1)
            if args.mesh % d == 0 and d <= max(1, n_configs))
        return build_mesh(args.mesh, sweep=s)
    if args.scan_input == "sad":
        if args.vectors is not None:
            parser.error("--vectors does not apply to --scan-input sad "
                         "(the SAD path has no per-block vote counts)")
        thresholds = [float(x) for x in
                      (args.thresholds or "4,12,30").split(",")]
        # the SAD route flattens (threshold x clusters) onto one config
        # axis, so the whole grid shards over 'sweep'
        results = sweep_sad(args.input, thresholds, clusters,
                            device_stats=args.device_stats,
                            mesh=make_mesh(len(thresholds) * len(clusters)))
        print(json.dumps(results, indent=2))
        return 0

    thresholds = [float(x) for x in
                  (args.thresholds or "4,16,64").split(",")]
    vectors = [int(x) for x in (args.vectors or "1,2,4").split(",")]
    results = sweep(args.input, thresholds, vectors, clusters,
                    device_stats=args.device_stats,
                    scan_input=args.scan_input,
                    mesh=make_mesh(len(vectors) * len(clusters)))
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
