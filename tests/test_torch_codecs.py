"""Twin of tests/test_codecs.py on the port's CPU build.

Every case of the JAX suite (HEVC to the SAD path, the HEVC MV path where
libav exports it, the copy decision, MPEG-2 MVs, the 4K grid, B-frames,
sensor noise, the mkv/ts/avi containers), fed the same kind of clip to the
JAX package and to the port (``scan_backend="torch"``).  The scans, the
cluster decisions, the seconds removed and the saved share must be equal
exactly, and each case's own assertions hold on the port's result.  The
HEVC clip is 640x360 and the 4K clip 2 s, smaller than the JAX suite's.
"""

import os

import numpy as np
import pytest

from mvtrim_tpu.core import oracle as jax_oracle
from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.io import native as jax_native
from mvtrim_tpu.models.mv_detector import MVClusterDetector as JaxDetector
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline as JaxPipeline
from mvtrim_tpu.tools import extract_mvs as jax_extract_mvs
from mvtrim_tpu.utils.timing import TimingCollector as JaxTiming
from mvtrim_tpu_torch.core import Config, GridGeometry, oracle
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.tools import extract_mvs
from mvtrim_tpu_torch.utils.timing import TimingCollector


@pytest.fixture(autouse=True)
def clear_timing():
    yield
    TimingCollector.clear()
    JaxTiming.clear()


def both_runs(clip, tmp_path, tag, jax_backend="xla", **cfg):
    """The port's pipeline (CPU build) and the JAX package's on one clip:
    the port's pipeline, after both results are held equal."""
    ours = ProcessingPipeline(clip, str(tmp_path / f"{tag}_ours.mp4"),
                              cfg=Config(scan_backend="torch", **cfg))
    theirs = JaxPipeline(clip, str(tmp_path / f"{tag}_theirs.mp4"),
                         cfg=JaxConfig(scan_backend=jax_backend, **cfg))
    assert ours.run() == 0 and theirs.run() == 0
    assert (ours.time_removed, ours.saved_pct) == \
        (theirs.time_removed, theirs.saved_pct)
    return ours


def both_scans(clip, scan, mode=native.MVT_MODE_MV, **kw):
    """One native scan through each package's ctypes bridge: equal."""
    with native.VideoReader(clip, mode) as r:
        ours = getattr(r, scan)(**kw)
    with jax_native.VideoReader(clip, mode) as r:
        theirs = getattr(r, scan)(**kw)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    return ours


def grid_args(geom, **kw):
    return dict(gw=geom.gw, gh=geom.gh, y_min=geom.y_min, y_max=geom.y_max,
                **kw)


class TestHEVC:
    @pytest.fixture(scope="class")
    def hevc_clip(self, tmp_path_factory):
        path = str(tmp_path_factory.mktemp("codecs") / "hevc.mp4")
        native.synthesize(path, width=640, height=360, fps=25.0,
                          duration=10.0, codec="libx265",
                          motion_windows=((2.0, 4.0),))
        return path

    def test_decodes_and_trims_via_sad_fallback(self, hevc_clip, tmp_path):
        with native.VideoReader(hevc_clip) as r:
            assert r.width == 640 and r.height == 360
        p = both_runs(hevc_clip, tmp_path, "hevc")
        assert os.path.exists(p.output_path)
        assert 50.0 < p.saved_pct < 85.0
        with native.VideoReader(p.output_path) as r:
            assert 2.0 < r.duration < 5.0

    def test_mv_path_when_runtime_capable(self, hevc_clip):
        """Capability-gated as in the JAX suite: skips on libav builds
        that export no HEVC MV side data."""
        if not native.hevc_mv_export_capable():
            pytest.skip("linked libavcodec exports no HEVC MV side data "
                        "(FFmpeg < 7); deployment image builds FFmpeg 8")
        assert jax_native.hevc_mv_export_capable()
        cfg = Config()
        with native.VideoReader(hevc_clip) as r:
            geom = GridGeometry.build(r.width, r.height, cfg)
            duration = r.duration
        tm = native.ScanTiming()
        grids, _ = both_scans(
            hevc_clip, "scan_grids", start=0.0, end=duration + 1,
            **grid_args(geom, threshold_sq=cfg.mv_threshold_sq,
                        block_shift=cfg.block_shift, max_frames=300))
        with native.VideoReader(hevc_clip) as r:
            r.scan_grids(0.0, duration + 1, **grid_args(
                geom, threshold_sq=cfg.mv_threshold_sq,
                block_shift=cfg.block_shift, max_frames=300, timing=tm))
        assert tm.frames_with_mvs > 0
        assert grids.sum() > 0

    def test_min_savings_copy_decision(self, hevc_clip, tmp_path):
        p = both_runs(hevc_clip, tmp_path, "copy", min_savings_pct=99.0)
        with native.VideoReader(hevc_clip) as a, \
                native.VideoReader(p.output_path) as b:
            assert abs(a.duration - b.duration) < 0.5


def decide_both(grids, width, height, **cfg):
    """The port's grids decision (CPU build) against the JAX package's
    (XLA): equal; the port's."""
    ours = MVClusterDetector(width, height, Config(
        scan_backend="torch", **cfg)).scan_votes(grids)
    theirs = JaxDetector(width, height, JaxConfig(
        scan_backend="xla", **cfg)).scan_votes(grids)
    np.testing.assert_array_equal(ours, theirs)
    return ours


class TestMPEG2:
    def test_mv_path_works(self, tmp_path):
        """mpeg2video is in the MV-exporting decoder family."""
        path = str(tmp_path / "m2.mpg")
        native.synthesize(path, width=640, height=480, fps=25.0,
                          duration=8.0, codec="mpeg2video",
                          motion_windows=((2.0, 4.0),))
        cfg = Config()
        with native.VideoReader(path) as r:
            geom = GridGeometry.build(r.width, r.height, cfg)
            duration = r.duration
            timing = native.ScanTiming()
            r.scan_grids(0.0, duration, **grid_args(
                geom, threshold_sq=cfg.mv_threshold_sq,
                block_shift=cfg.block_shift, max_frames=256, timing=timing))
        assert timing.frames_with_mvs > 0, "mpeg2 exported no MVs"
        grids, pts = both_scans(path, "scan_grids", start=0.0, end=duration,
                                **grid_args(geom,
                                            threshold_sq=cfg.mv_threshold_sq,
                                            block_shift=cfg.block_shift,
                                            max_frames=256))
        assert grids.max() >= 1
        # one MV a macroblock, as in the B-frame clip: one vote a cell
        motion = decide_both(grids, 640, 480, vectors_needed=1)
        assert motion.any() and all(1.5 <= t <= 4.5 for t in pts[motion])


class Test4K:
    def test_large_grid_mv_path(self, tmp_path):
        """4K H.264: the 240x135 grid through the MV path end to end."""
        path = str(tmp_path / "uhd.mp4")
        native.synthesize(path, width=3840, height=2160, fps=25.0,
                          duration=2.0, codec="libx264",
                          motion_windows=((0.8, 1.1),))
        cfg = Config()
        geom = GridGeometry.build(3840, 2160, cfg)
        assert (geom.gw, geom.gh) == (240, 135)
        assert cfg.vertical_margin(geom.gh) == 6
        p = both_runs(path, tmp_path, "uhd")
        assert os.path.exists(p.output_path)
        assert p.saved_pct > 30.0


class TestBFrames:
    @pytest.fixture(scope="class")
    def b_clip(self, tmp_path_factory):
        path = str(tmp_path_factory.mktemp("bframes") / "b.mp4")
        native.synthesize(path, width=320, height=240, fps=25.0,
                          duration=10.0, codec="libx264",
                          motion_windows=((2.0, 4.0),), b_frames=2)
        return path

    def test_clip_has_b_frames(self, b_clip):
        doc = extract_mvs.extract(b_clip)
        assert doc == jax_extract_mvs.extract(b_clip)
        types = {f["frame_type"] for f in doc["frames"]}
        assert "B" in types, f"no B-frames produced: {types}"
        idx = [f["frame_index"] for f in doc["frames"]]
        assert idx == list(range(1, len(idx) + 1))
        assert len(idx) >= 240

    def test_scan_skips_bidir_like_reference(self, b_clip):
        """B-frames are not analyzed, but motion is still found on
        P-frames, by both packages' oracles and by the port's kernel
        path."""
        with native.VideoReader(b_clip) as r:
            geom = GridGeometry.build(r.width, r.height, Config())
            duration = r.duration
        grids, pts = both_scans(b_clip, "scan_grids", start=0.0,
                                end=duration, **grid_args(
                                    geom, threshold_sq=16.0, block_shift=4,
                                    max_frames=512))
        assert 0 < len(pts) < 240
        counts = oracle.count_clusters_batch(
            grids, vectors_needed=1, y_min=geom.y_min, y_max=geom.y_max)
        np.testing.assert_array_equal(counts, jax_oracle.count_clusters_batch(
            grids, vectors_needed=1, y_min=geom.y_min, y_max=geom.y_max))
        motion = pts[counts >= oracle.effective_clusters_needed(2)]
        assert len(motion) > 5
        assert all(1.9 <= p <= 4.1 for p in motion)
        kernel = decide_both(grids, 320, 240, vectors_needed=1)
        np.testing.assert_array_equal(pts[kernel], motion)

    def test_pipeline_and_cut_on_b_frames(self, b_clip, tmp_path):
        p = both_runs(b_clip, tmp_path, "b", jax_backend="oracle",
                      vectors_needed=1)
        assert os.path.exists(p.output_path)
        with native.VideoReader(p.output_path) as r:
            _, pts = r.scan_grids(0.0, r.duration, threshold_sq=16.0,
                                  block_shift=4, gw=20, gh=15, y_min=0,
                                  y_max=15, max_frames=256)
            assert len(pts) > 30


class TestNoisyCCTV:
    def test_threshold_rejects_noise(self, tmp_path):
        path = str(tmp_path / "noisy.mp4")
        native.synthesize(path, width=640, height=480, fps=25.0,
                          duration=12.0, codec="libx264",
                          motion_windows=((3.0, 6.0),), noise=6)
        p0 = both_runs(path, tmp_path, "o0", jax_backend="oracle")
        assert p0.saved_pct < 20.0
        p1 = both_runs(path, tmp_path, "o1", jax_backend="oracle",
                       mv_threshold_sq=64.0)
        assert 50.0 < p1.saved_pct < 80.0

    def test_noise_increases_mv_count(self, tmp_path):
        totals = {}
        for name, noise in (("quiet", 0), ("noisy", 8)):
            path = str(tmp_path / f"{name}.mp4")
            native.synthesize(path, width=320, height=240, fps=25.0,
                              duration=4.0, codec="libx264",
                              motion_windows=(), noise=noise)
            with native.VideoReader(path) as r:
                duration = r.duration
            _, counts, _ = both_scans(path, "scan_mvs", start=0.0,
                                      end=duration, max_frames=128)
            totals[name] = int(np.abs(counts).sum())
        assert totals["noisy"] > totals["quiet"]


class TestContainers:
    @pytest.mark.parametrize("ext", ["mkv", "ts", "avi"])
    def test_scan_and_cut(self, tmp_path, ext):
        path = str(tmp_path / f"c.{ext}")
        codec = "mpeg4" if ext == "avi" else "libx264"
        native.synthesize(path, width=320, height=240, fps=25.0,
                          duration=8.0, codec=codec,
                          motion_windows=((2.0, 4.0),))
        with native.VideoReader(path) as r:
            geom = GridGeometry.build(r.width, r.height, Config())
            duration = r.duration
        grids, pts = both_scans(path, "scan_grids", start=0.0, end=duration,
                                **grid_args(geom, threshold_sq=16.0,
                                            block_shift=4, max_frames=256))
        assert len(pts) > 150
        decide_both(grids, 320, 240)
        durations = []
        for name, bridge in (("ours", native), ("theirs", jax_native)):
            out = str(tmp_path / f"{name}.{ext}")
            bridge.cut(path, out, [(1.5, 4.5)])
            with native.VideoReader(out) as r:
                durations.append(r.duration)
        assert 2.0 < durations[0] < 5.5
        assert durations[0] == durations[1]
