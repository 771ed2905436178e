"""Smoke run of mvtrim_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version and the NumPy oracle at the geometries
the scan path meets, drives the default MV scan path end to end, and times
the kernel against the plain version at 1080p.  Every phase raises on a
failure, so any failure exits nonzero.  The last two lines of standard
output are one JSON line per kernel of the path and the result line
``{"ok": true, "device": {...}}``.

Phase 4 drives ``python -m mvtrim_tpu_torch``'s ``main`` on a synthetic
1080p clip when the native host library (FFmpeg's libav*) loads.  Where it
does not, the phase says so on its own line and drives the device half of
the path instead: seeded 1080p activity masks through
``MVClusterDetector`` and on through merging, segmentation and the cut
decision.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mvtrim_tpu_torch import Config, GridGeometry, native, oracle  # noqa: E402
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector  # noqa: E402
from mvtrim_tpu_torch.ops import _build  # noqa: E402
from mvtrim_tpu_torch.ops import cluster as cluster_ops  # noqa: E402

KERNEL_REPLACES = "mvtrim_tpu/ops/cluster.py:444"
GEOMETRIES = [  # (width, height, vertical_mask)
    (1920, 1080, 0.05),   # gw=120, not a multiple of 32
    (3840, 2160, 0.05),   # 4K
    (360, 240, 0.0),      # margin 0: rows 0 and gh-1 are centres
    (200, 144, 0.05),     # gw=13, less than one word
    (1024, 576, 0.05),    # gw=64, a multiple of 32
    (512, 2048, 0.0),     # one word per row, margin 0
]
BATCHES = (4096, 1, 777)
FPS = 25.0
CLIP_SEC = 60.0
MOTION_WINDOWS = ((5.0, 12.0), (40.0, 44.0))


def log(msg: str) -> None:
    print(msg, flush=True)


def random_masks(rng, n: int, geom: GridGeometry):
    """Seeded activity masks: bool [n, gh, gw] and their mvt_scan_bits
    packing uint8 [n, gh, ceil(gw/8)].  Three frames in four have density
    0.3, the fourth 0.0003, so motion is decided both ways."""
    density = np.where(np.arange(n) % 4 == 3, 3e-4, 0.3).astype(np.float32)
    active = rng.random((n, geom.gh, geom.gw),
                        dtype=np.float32) < density[:, None, None]
    return active, np.packbits(active, axis=2, bitorder="little")


def oracle_counts(active: np.ndarray, geom: GridGeometry) -> np.ndarray:
    return np.concatenate([
        oracle.count_clusters_batch(
            active[i:i + 512].astype(np.uint8), vectors_needed=1,
            y_min=geom.y_min, y_max=geom.y_max)
        for i in range(0, len(active), 512)])


# --- phase 1 ---

def phase_environment() -> tuple[str, bool]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    have_pc = shutil.which("pkg-config") is not None
    missing = [p for p in ("libavformat", "libavcodec", "libavutil")
               if not have_pc
               or subprocess.run(["pkg-config", "--exists", p]).returncode]
    try:
        native._load_library()
    except OSError as e:
        log("native host library unavailable: libav development packages "
            f"missing here ({', '.join(missing) or 'none reported'}); "
            f"{str(e).splitlines()[0]}")
        log("phase 4 runs the device half of the path on seeded 1080p "
            "masks instead of a decoded clip")
        return card, False
    log("native host library: loaded")
    return card, True


# --- phase 2 ---

def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_library()
    info = _build.build_info
    log(f"kernel build: {info.get('seconds', 0.0):.3f} s nvcc, "
        f"{time.perf_counter() - t0:.3f} s to build and load "
        f"({os.path.relpath(_build.library_path())})")
    for line in info.get("report", "").splitlines():
        log(f"  {line}")


# --- phase 3 ---

def phase_correctness(rng) -> int:
    """Kernel vs plain (CPU) vs oracle, exact.  Returns max |kernel-plain|."""
    worst = 0
    for width, height, vm in GEOMETRIES:
        cfg = Config(vertical_mask=vm)
        geom = GridGeometry.build(width, height, cfg)
        for b in BATCHES:
            active, bits = random_masks(rng, b, geom)
            words = cluster_ops.repack_bits_words(bits, geom)
            counts, motion = cluster_ops.cluster_words_op(
                torch.from_numpy(words).cuda(), geom, cfg.clusters_needed)
            torch.cuda.synchronize()
            counts = counts.cpu().numpy()
            motion = motion.cpu().numpy()
            plain = cluster_ops.word_cluster_counts_plain(
                torch.from_numpy(words), geom).numpy()
            expect = oracle_counts(active, geom)
            need = oracle.effective_clusters_needed(cfg.clusters_needed)
            worst = max(worst, int(np.abs(counts.astype(np.int64)
                                          - plain).max()))
            ok = (np.array_equal(counts, plain)
                  and np.array_equal(counts, expect)
                  and np.array_equal(motion, expect >= need))
            log(f"{width}x{height} vm={vm} B={b}: kernel == plain == "
                f"oracle: {ok} (mean count {expect.mean():.1f}, "
                f"motion {int(motion.sum())}/{b})")
            if not ok:
                raise AssertionError(
                    f"kernel disagrees at {width}x{height} B={b}: "
                    f"{int((counts != expect).sum())} counts differ")
    return worst


# --- phase 4 ---

def _segments_text(segments) -> list[tuple[float, float]]:
    return [(s.start, s.end) for s in segments]


def synthetic_masks(seed: int, geom: GridGeometry):
    """A 60 s, 25 fps 1080p scan's activity masks: isolated noise cells
    (never 4-adjacent, so never a cluster) in every frame, plus a moving
    blob inside MOTION_WINDOWS.  Returns (bits, pts)."""
    rng = np.random.default_rng(seed)
    n = int(CLIP_SEC * FPS)
    pts = np.arange(n) / FPS
    active = np.zeros((n, geom.gh, geom.gw), bool)
    lattice = np.zeros((geom.gh, geom.gw), bool)
    lattice[::2, ::2] = True
    active[:] = lattice & (rng.random((n, geom.gh, geom.gw)) < 0.02)
    for lo, hi in MOTION_WINDOWS:
        for i in np.nonzero((pts >= lo) & (pts < hi))[0]:
            x = 4 + int(i * 0.8) % (geom.gw - 20)
            y = geom.gh // 3
            active[i, y:y + 10, x:x + 12] |= rng.random((10, 12)) < 0.7
    return np.packbits(active, axis=2, bitorder="little"), pts


def _scan_masks(detector: MVClusterDetector, bits: np.ndarray, pts, words):
    """The pipeline's feeder over 30 s chunks: dispatch every chunk, then
    resolve in order."""
    chunk = int(30 * FPS)
    pending = []
    for lo in range(0, len(pts), chunk):
        if words:
            data = cluster_ops.repack_bits_words(bits[lo:lo + chunk],
                                                 detector.geom)
            pending.append((pts[lo:lo + chunk],
                            detector.scan_words_async(data)))
        else:
            pending.append((pts[lo:lo + chunk],
                            detector.scan_bits_async(bits[lo:lo + chunk])))
    motion_ts = []
    for p, resolve in pending:
        motion_ts.extend(p[resolve()].tolist())
    return motion_ts


def _decide(motion_ts, cfg: Config):
    ts = oracle.merge_timestamps(motion_ts)
    segments = oracle.segments_from_timestamps(
        ts, max_gap_sec=cfg.max_gap_sec, padding_sec=cfg.padding_sec,
        duration=CLIP_SEC)
    return oracle.decide_cut(segments, CLIP_SEC, cfg.min_savings_pct)


def phase_end_to_end_masks(seed: int) -> dict:
    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    bits, pts = synthetic_masks(seed, geom)
    ref = MVClusterDetector(1920, 1080, Config(scan_backend="oracle"))
    ref_ts = _scan_masks(ref, bits, pts, words=False)
    ref_cut = _decide(ref_ts, cfg)
    timings = {}
    for words in (False, True):
        name = "words" if words else "bits"
        det = MVClusterDetector(1920, 1080, cfg)  # auto -> cuda
        assert det.backend == "cuda", det.backend
        t0 = time.perf_counter()
        motion_ts = _scan_masks(det, bits, pts, words)
        scan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        is_cut, segments = _decide(motion_ts, cfg)
        decide_s = time.perf_counter() - t0
        same = (motion_ts == ref_ts and is_cut == ref_cut[0]
                and segments == ref_cut[1])
        log(f"e2e masks [{name}] 1080p {len(pts)} frames: "
            f"{len(motion_ts)} motion frames, cut={is_cut}, segments "
            f"{_segments_text(segments)}; identical to the oracle "
            f"backend: {same}; scan {scan_s * 1e3:.3f} ms, "
            f"merge+segment+decide {decide_s * 1e3:.3f} ms")
        if not same:
            raise AssertionError(f"{name}: differs from the oracle backend")
        timings[name] = {"scan_ms": scan_s * 1e3,
                         "decide_ms": decide_s * 1e3}
    # the blob windows, padded by PADDING_SEC, are what a cut keeps
    for (lo, hi), seg in zip(MOTION_WINDOWS, ref_cut[1]):
        if not (abs(seg.start - (lo - cfg.padding_sec)) < 0.05
                and abs(seg.end - (hi - 1 / FPS + cfg.padding_sec)) < 0.05):
            raise AssertionError(f"segment {seg} does not match {lo}-{hi}")
    if len(ref_cut[1]) != len(MOTION_WINDOWS) or not ref_cut[0]:
        raise AssertionError(f"unexpected cut {ref_cut}")
    return timings


def phase_end_to_end_clip(workdir: str) -> dict:
    from mvtrim_tpu_torch.cli import main as cli_main
    from mvtrim_tpu_torch.pipeline.pipeline import (ProcessingPipeline,
                                                    TimingCollector)

    clip = os.path.join(workdir, "cam1080.mp4")
    t0 = time.perf_counter()
    native.synthesize(clip, width=1920, height=1080, fps=FPS,
                      duration=CLIP_SEC, codec="libx264", noise=2,
                      motion_windows=MOTION_WINDOWS)
    log(f"synthesized {clip} in {time.perf_counter() - t0:.3f} s")
    results = {}
    for name, env in (("oracle", {"MVT_SCAN_BACKEND": "oracle"}),
                      ("bits", {}), ("words", {"MVT_SCAN_INPUT": "words"})):
        out = os.path.join(workdir, f"out_{name}.mp4")
        metrics = os.path.join(workdir, f"metrics_{name}.jsonl")
        saved = {k: os.environ.get(k) for k in
                 ("MVT_SCAN_BACKEND", "MVT_SCAN_INPUT", "MVT_METRICS_JSON")}
        os.environ.update(env, MVT_METRICS_JSON=metrics)
        try:
            TimingCollector.clear()
            t0 = time.perf_counter()
            rc = cli_main([clip, out])
            wall = time.perf_counter() - t0
            # the motion timestamps themselves: one more scan, same config
            pipe = ProcessingPipeline(clip, out, cfg=Config.from_env())
            with native.VideoReader(clip) as r:
                pipe.duration = r.duration
                fps, w, h = r.fps, r.width, r.height
            motion_ts = sorted(pipe._parallel_scan(fps, w, h).motion_ts)
            TimingCollector.clear()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if rc != 0:
            raise AssertionError(f"{name}: cli exit {rc}")
        with native.VideoReader(out) as r:
            out_dur = r.duration
        with open(metrics) as f:
            rec = json.loads(f.readlines()[-1])
        results[name] = (motion_ts, out_dur, rec)
        log(f"e2e clip [{name}] rc={rc} wall {wall:.3f} s, output "
            f"{out_dur:.3f} s, saved {rec['saved_pct']:.3f}%, phases_us "
            f"{json.dumps(rec['phases_us'])}")
    ref_ts, ref_dur, _ = results["oracle"]
    for name in ("bits", "words"):
        motion_ts, out_dur, _ = results[name]
        if motion_ts != ref_ts or abs(out_dur - ref_dur) > 1e-3:
            raise AssertionError(f"{name}: differs from the oracle backend")
    return {k: v[2]["phases_us"] for k, v in results.items()}


# --- phase 5 ---

def _time(fn, batches, iters: int) -> tuple[float, torch.Tensor]:
    """ms per call over `iters` calls rotating through `batches`; the
    counts of every call are kept and summed after the clock stops."""
    outs = []
    for i in range(3):
        fn(batches[i % len(batches)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        outs.append(fn(batches[i % len(batches)]))
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, torch.stack(outs).sum()


def phase_timing(rng, card: str) -> tuple[float, float]:
    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    b, n_batches = 2048, 32
    batches, ref = [], []
    for _ in range(n_batches):
        _, bits = random_masks(rng, b, geom)
        words = torch.from_numpy(cluster_ops.repack_bits_words(bits, geom))
        ref.append(int(cluster_ops.word_cluster_counts_plain(
            words, geom).sum()))
        batches.append(words.cuda())
    mbytes = sum(t.numel() * 4 for t in batches) / 1e6

    def kernel(w):
        return cluster_ops.cluster_words_op(w, geom, cfg.clusters_needed)[0]

    def plain(w):
        return cluster_ops.word_cluster_counts_plain(w, geom)

    runs = {}
    for name, fn, iters in (("plain", plain, 64), ("kernel", kernel, 512),
                            ("kernel", kernel, 512), ("plain", plain, 64)):
        ms, checksum = _time(fn, batches, iters)
        expect = sum(ref[i % n_batches] for i in range(iters))
        if int(checksum) != expect:
            raise AssertionError(f"{name}: checksum {int(checksum)} != "
                                 f"{expect}")
        runs.setdefault(name, []).append(ms)
    k_ms = sum(runs["kernel"]) / 2
    p_ms = sum(runs["plain"]) / 2
    log(f"timing 1080p B={b} over {n_batches} batches ({mbytes:.1f} MB) on "
        f"{card}: kernel {k_ms * 1e3:.3f} us/batch "
        f"({b / k_ms * 1e3:.0f} frames/s; runs {runs['kernel']} ms), "
        f"plain {p_ms * 1e3:.3f} us/batch ({b / p_ms * 1e3:.0f} frames/s; "
        f"runs {runs['plain']} ms)")

    # where a launch's time goes: host enqueue vs the kernel on the card
    iters = 256
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        kernel(batches[i % n_batches])
    host_us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    log(f"host enqueue per kernel call (wrapper + launch): {host_us:.3f} us")
    log(f"kernel device time per launch (torch.profiler): "
        f"{_profiled_kernel_us(kernel, batches)}")

    # a batch far past the L2 cache: the kernel's own bandwidth
    big = torch.cat(batches)
    halves = [big[: len(big) // 2], big[len(big) // 2:]]
    reps = [_time(kernel, halves, 64)[0] for _ in range(3)]
    big_ms = sorted(reps)[1]
    nbytes = halves[0].numel() * 4 + len(halves[0]) * 5
    log(f"kernel 1080p B={len(halves[0])} ({nbytes / 1e6:.1f} MB/launch): "
        f"median of {[round(r * 1e3, 3) for r in reps]} = "
        f"{big_ms * 1e3:.3f} us/launch, {nbytes / big_ms / 1e9:.3f} TB/s "
        f"of 3.35 TB/s peak, {len(halves[0]) / big_ms * 1e3:.0f} frames/s")
    return k_ms, p_ms


def _profiled_kernel_us(fn, batches) -> str:
    """Mean device time of the word_cluster kernel over 64 calls, and the
    card's busy share across those calls (host clock, profiler running),
    from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(64):
            fn(batches[i % len(batches)])
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    for ev in prof.key_averages():
        if "word_cluster_kernel" in ev.key:
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            if dev_us <= 0:
                break
            return (f"{dev_us / ev.count:.3f} us over {ev.count} launches; "
                    f"card busy {dev_us / window_us * 100:.2f}% of the "
                    f"{window_us:.0f} us host window")
    return "not measured (the trace holds no device time for the kernel)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    rng = np.random.default_rng(args.seed)

    card, have_native = phase_environment()
    phase_build()
    worst = phase_correctness(rng)

    cluster_ops.cluster_words_op.launches = 0
    if have_native:
        with tempfile.TemporaryDirectory() as workdir:
            phase_end_to_end_clip(workdir)
    else:
        phase_end_to_end_masks(args.seed)
    launches = cluster_ops.cluster_words_op.launches
    log(f"word_cluster kernel launches in the main-path run: {launches}")
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")

    k_ms, p_ms = phase_timing(rng, card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "word_cluster_counts", "route": "cuda",
        "source": "mvtrim_tpu_torch/csrc/word_cluster.cu",
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
