"""The raw-MV path at a noisy 1080p camera's MV counts, through the port's
normal path, against the benchmark's plain reference
(``trimbench/reference/mvs.py``): fixture B (1080p x264, B-frames, sensor
noise; past 8,192 MVs in most frames) replayed through the mv_raw
pipeline at the shipped capacity, in one chunk and in 1-s chunks that
carry the file's capacity, and the detector deciding the same frames at
every capacity that holds them.  Each test runs on the plain
build here and, marked ``cuda``, on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_mvraw_card.py
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from mvtrim_tpu_torch.bench import replay
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.utils import timing
from mvtrim_tpu_torch.utils.timing import TimingCollector
from trimbench import scene, spec
from trimbench.reference import mvs as ref_mvs
from trimbench.reference import rule
from trimbench.reference import segments as ref_segments

BACKENDS = [pytest.param("torch", id="plain"),
            pytest.param("auto", id="cuda", marks=pytest.mark.cuda)]
# 26,624: what the pipeline's restart asks for at the 1080p pool's counts
# (its largest plus an eighth, rounded up to 1,024 rows), not a power of two
CAPACITIES = (8192, 16384, 26624, 32768)


def backend_here(backend: str) -> str:
    if backend == "auto" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_mvraw_card.py)")
    return backend


def knobs_of(cfg: Config) -> dict:
    return dict(MV_THRESHOLD_SQ=cfg.mv_threshold_sq,
                BLOCK_SHIFT=cfg.block_shift,
                VECTORS_NEEDED=cfg.vectors_needed,
                CLUSTERS_NEEDED=cfg.clusters_needed,
                MAX_GAP_SEC=cfg.max_gap_sec, PADDING_SEC=cfg.padding_sec,
                MIN_SAVINGS_PCT=cfg.min_savings_pct)


def fixture_b():
    """(fixture, its frames as a reference pool, the grid)."""
    fx = replay.load("B")
    counts = fx.arrays["mv_counts"].astype(np.int32)
    rows = fx.arrays["mv_fields"].T
    fields = np.zeros((len(counts), counts.max(), 4), np.int16)
    for i, (lo, hi) in enumerate(zip(fx.mv_offsets[:-1],
                                     fx.mv_offsets[1:])):
        fields[i, :hi - lo] = rows[lo:hi]
    k = fx.meta["knobs"]
    geom = rule.Geometry(fx.meta["width"], fx.meta["height"], 16, k["gw"],
                         k["gh"], k["y_min"], k["y_max"])
    return fx, (fields, counts), geom


@pytest.mark.parametrize("backend", BACKENDS)
def test_fixture_b_through_the_mv_raw_pipeline(backend, tmp_path,
                                               monkeypatch):
    fx, pool, geom = fixture_b()
    cfg = fx.config(scan_backend=backend_here(backend), scan_input="mv_raw",
                    mv_capacity=8192, ffmpeg_bin=replay.FAKE_FFMPEG)
    assert (pool[1] > cfg.mv_capacity).sum() >= len(pool[1]) // 2
    src = str(tmp_path / "b.mp4")
    dump = str(tmp_path / "b.concat")
    monkeypatch.setenv("MVT_CONCAT_DUMP", dump)
    monkeypatch.setattr(native, "VideoReader", replay.opener(fx))
    try:
        assert ProcessingPipeline(src, src + ".out", cfg=cfg).run() == 0
    finally:
        TimingCollector.clear()
    with open(dump) as f:
        got = f.read()
    knobs = knobs_of(cfg)
    motion = ref_mvs.Decider(pool, geom, knobs)(np.arange(len(pool[1])),
                                                None)
    _, want = ref_segments.cut_of(fx.pts[motion], fx.meta["duration"],
                                  os.path.abspath(src), knobs)
    assert got == want == fx.concat(src)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fixture_b_with_the_carry_through_the_mv_raw_pipeline(
        backend, tmp_path, monkeypatch):
    """Fixture B in 1-s chunks on two decode workers: the chunks after a
    worker's first start at the capacity carried from the file's restarts
    (capacities that are no power of two), and the cut is the plain
    reference's."""
    fx, pool, geom = fixture_b()
    cfg = fx.config(scan_backend=backend_here(backend), scan_input="mv_raw",
                    mv_capacity=8192, chunk_duration_sec=1.0,
                    decode_workers=2, ffmpeg_bin=replay.FAKE_FFMPEG)
    src = str(tmp_path / "b.mp4")
    dump = str(tmp_path / "b.concat")
    monkeypatch.setenv("MVT_CONCAT_DUMP", dump)
    monkeypatch.setattr(native, "VideoReader", replay.opener(fx))
    timing.start_recording()
    try:
        assert ProcessingPipeline(src, src + ".out", cfg=cfg).run() == 0
    finally:
        spans = timing.stop_recording()
        TimingCollector.clear()
    carried = [s.value for s in spans if s.name == "scan.mv_carried"]
    assert carried and all(c % 1024 == 0 for c in carried)
    assert any(c & (c - 1) for c in carried)
    with open(dump) as f:
        got = f.read()
    knobs = knobs_of(cfg)
    motion = ref_mvs.Decider(pool, geom, knobs)(np.arange(len(pool[1])),
                                                None)
    _, want = ref_segments.cut_of(fx.pts[motion], fx.meta["duration"],
                                  os.path.abspath(src), knobs)
    assert got == want == fx.concat(src)


def frames_at(fields: np.ndarray, counts: np.ndarray, cap: int):
    """The payload at capacity ``cap``, as the native scan hands it over."""
    out = np.zeros((len(counts), cap, 4), np.int16)
    held = min(cap, fields.shape[1])
    out[:, :held] = fields[:, :held]
    return out, np.where(counts > cap, -counts, counts).astype(np.int32)


def scene_pool():
    cfg = spec.load_config("cctv1080_h264_mvraw")
    camera, knobs = cfg["camera"], cfg["env"]
    geom = rule.Geometry.of(camera["width"], camera["height"], knobs)
    sc = scene.build("mvs", camera, cfg["scene"]["mvs"], geom, 2 ** 31 + 77)
    return sc.pool, geom, knobs


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("source", ["fixture_b", "scene"])
def test_every_capacity_that_holds_a_frame_decides_it_alike(backend,
                                                            source):
    if source == "fixture_b":
        fx, (fields, counts), geom = fixture_b()
        cfg = fx.config(scan_backend=backend_here(backend))
        knobs = knobs_of(cfg)
    else:
        (fields, counts), geom, knobs = scene_pool()
        cfg = dataclasses.replace(Config(), scan_backend=backend_here(
            backend), mv_threshold_sq=float(knobs["MV_THRESHOLD_SQ"]))
    want = ref_mvs.decide(fields, counts, geom, knobs)
    assert want.any() and not want.all()
    detector = MVClusterDetector(geom.width, geom.height, cfg)
    fit = counts <= CAPACITIES[0]
    assert fit.sum() >= 5 and (~fit).sum() >= 5
    for cap in CAPACITIES:
        mvs, c = frames_at(fields[fit], counts[fit], cap)
        np.testing.assert_array_equal(detector.scan_raw_mvs(mvs, c),
                                      want[fit], err_msg=f"M={cap}")
    assert counts.max() <= 26624
    for cap in CAPACITIES:
        if cap >= counts.max():
            mvs, c = frames_at(fields, counts, cap)
            np.testing.assert_array_equal(detector.scan_raw_mvs(mvs, c),
                                          want, err_msg=f"M={cap}")
    # a list past the capacity is refused, not guessed
    mvs, c = frames_at(fields, counts, CAPACITIES[0])
    with pytest.raises(ValueError):
        detector.scan_raw_mvs(mvs, c)


@pytest.mark.cuda
def test_cuda_batches_in_flight_hold_no_rows():
    """The feeder holds every batch of a file until the file's scan ends:
    on the card each holds its motion and event, not its staged and
    device rows."""
    backend_here("auto")
    (fields, counts), geom, knobs = scene_pool()
    cfg = dataclasses.replace(Config(), scan_backend="auto",
                              mv_threshold_sq=float(knobs["MV_THRESHOLD_SQ"]))
    detector = MVClusterDetector(geom.width, geom.height, cfg)
    mvs, c = frames_at(fields, counts, CAPACITIES[-1])
    detector.scan_raw_mvs(mvs, c)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    resolvers = [detector.scan_raw_mvs_async(mvs, c) for _ in range(12)]
    assert torch.cuda.memory_allocated() - base < 2 * mvs.nbytes
    want = ref_mvs.decide(fields, counts, geom, knobs)
    for resolve in resolvers:
        np.testing.assert_array_equal(resolve(), want)
