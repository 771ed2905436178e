"""Twin of tests/test_scan_input.py on the port's CPU build.

MVT_SCAN_INPUT parity (bits, words, grids, mv_raw) and the MV-capacity
overflow contract, every case of the JAX suite on the same clips: the
native scans through the port's ctypes bridge equal the JAX package's,
the port's detector (``scan_backend="torch"``, and ``oracle``) decides
as the JAX package's does (XLA, and its Pallas bits kernel in interpret
mode), and the port's pipeline cuts every payload as the JAX package's
pipeline cuts the bits payload, with exact frame statistics and
heatmaps.
"""

import json
import os

import numpy as np
import pytest

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.io import native as jax_native
from mvtrim_tpu.models.mv_detector import MVClusterDetector as JaxDetector
from mvtrim_tpu.ops.cluster import repack_bits_words as jax_repack
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline as JaxPipeline
from mvtrim_tpu.utils.timing import TimingCollector as JaxTiming
from mvtrim_tpu_torch.core import Config, GridGeometry
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.ops.cluster import repack_bits_words
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.utils.timing import TimingCollector

INPUTS = ("bits", "words", "grids", "mv_raw")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    # 360px width -> gw=23 (not byte-aligned: exercises packed tail bits)
    path = str(tmp_path_factory.mktemp("scaninput") / "motion.mp4")
    native.synthesize(path, width=360, height=240, fps=25.0, duration=16.0,
                      codec="libx264",
                      motion_windows=((2.0, 4.0), (10.0, 12.0)))
    return path


@pytest.fixture(autouse=True)
def clear_timing():
    TimingCollector.clear()
    JaxTiming.clear()
    yield
    TimingCollector.clear()
    JaxTiming.clear()


def geom_of(clip, cfg):
    with native.VideoReader(clip) as r:
        return GridGeometry.build(r.width, r.height, cfg)


def both_scans(clip, scan, *args, **kw):
    """One native scan through each package's ctypes bridge: equal."""
    with native.VideoReader(clip) as r:
        ours = getattr(r, scan)(*args, **kw)
    with jax_native.VideoReader(clip) as r:
        theirs = getattr(r, scan)(*args, **kw)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    return ours


def grid_kw(cfg, geom, **kw):
    return dict(threshold_sq=cfg.mv_threshold_sq, block_shift=cfg.block_shift,
                gw=geom.gw, gh=geom.gh, y_min=geom.y_min, y_max=geom.y_max,
                **kw)


class TestNativeScanBits:
    def test_bits_match_thresholded_grids(self, clip):
        cfg = Config()
        geom = geom_of(clip, cfg)
        grids, pts_g = both_scans(clip, "scan_grids", 0.0, 99.0,
                                  **grid_kw(cfg, geom, max_frames=600))
        bits, pts_b = both_scans(clip, "scan_bits", 0.0, 99.0,
                                 **grid_kw(cfg, geom, max_frames=600,
                                           vectors_needed=2))
        np.testing.assert_array_equal(pts_g, pts_b)
        np.testing.assert_array_equal(bits, np.packbits(
            grids >= cfg.vectors_needed, axis=2, bitorder="little"))

    def test_bits_zero_threshold_sd_frames_only(self, clip):
        cfg = Config(vectors_needed=0)
        geom = geom_of(clip, cfg)
        timing = native.ScanTiming()
        bits, pts = both_scans(clip, "scan_bits", 0.0, 1.0,
                               **grid_kw(cfg, geom, vectors_needed=0,
                                         max_frames=30))
        with native.VideoReader(clip) as r:
            r.scan_bits(0.0, 1.0, **grid_kw(cfg, geom, vectors_needed=0,
                                            max_frames=30, timing=timing))
        unpacked = np.unpackbits(bits, axis=2, bitorder="little")
        per_frame = unpacked[:, :, :geom.gw].reshape(len(pts), -1)
        full = per_frame.all(axis=1)
        empty = ~per_frame.any(axis=1)
        assert (full | empty).all()
        assert int(full.sum()) == timing.frames_with_mvs
        assert full.any() and empty.any()
        assert not unpacked[:, :, geom.gw:].any()
        # and the port's kernel path decides these masks as the JAX one
        ours = MVClusterDetector(360, 240, Config(
            scan_backend="torch", vectors_needed=0)).scan_bits(bits)
        theirs = JaxDetector(360, 240, JaxConfig(
            scan_backend="xla", vectors_needed=0)).scan_bits(bits)
        np.testing.assert_array_equal(ours, theirs)


class TestNativeScanWords:
    def test_words_match_host_repack(self, clip):
        cfg = Config()
        geom = geom_of(clip, cfg)
        bits, pts_b = both_scans(clip, "scan_bits", 0.0, 99.0,
                                 **grid_kw(cfg, geom, max_frames=600,
                                           vectors_needed=2))
        words, pts_w = both_scans(clip, "scan_words", 0.0, 99.0,
                                  **grid_kw(cfg, geom, max_frames=600,
                                            vectors_needed=2))
        np.testing.assert_array_equal(pts_w, pts_b)
        np.testing.assert_array_equal(words, repack_bits_words(bits, geom))
        np.testing.assert_array_equal(words, jax_repack(bits, geom))


def random_packed(seed, det, cfg):
    rng = np.random.default_rng(seed)
    grids = rng.integers(0, 5, size=(70, det.geom.gh, det.geom.gw),
                         dtype=np.uint8)
    return grids, np.packbits(grids >= cfg.vectors_needed, axis=2,
                              bitorder="little")


class TestDetectorBits:
    @pytest.mark.parametrize("backend", ["torch", "oracle"])
    def test_bits_decision_equals_grids(self, backend):
        cfg = Config(scan_backend=backend, device_batch=32)
        det = MVClusterDetector(360, 240, cfg)
        grids, packed = random_packed(7, det, cfg)
        got = det.scan_bits(packed)
        np.testing.assert_array_equal(got, det.scan_votes(grids))
        jax = JaxDetector(360, 240, JaxConfig(scan_backend="xla",
                                              device_batch=32))
        np.testing.assert_array_equal(got, jax.scan_bits(packed))

    @pytest.mark.parametrize("db", [32, 1048, 1152])
    def test_bits_transposed_pallas_path(self, monkeypatch, db):
        """The port's bits path at device batch ``db`` decides as the JAX
        package's transposed Pallas kernel, run in interpret mode as the
        JAX suite runs it."""
        from mvtrim_tpu.models import mv_detector as mvd

        jax_det = JaxDetector(360, 240, JaxConfig(device_batch=db))
        monkeypatch.setattr(jax_det, "_bits_backend", lambda: "pallas")

        def fake_cached(geom, clusters_needed, backend, block_b):
            from mvtrim_tpu.ops.cluster import (
                make_cluster_words_op_pallas_T, make_cluster_words_op_xla)
            if backend == "pallas":
                assert jax_det.device_batch % block_b == 0
                return make_cluster_words_op_pallas_T(
                    geom, clusters_needed, block_b=block_b, interpret=True)
            return make_cluster_words_op_xla(geom, clusters_needed)

        monkeypatch.setattr(mvd.cluster_ops, "_cached_bits_op", fake_cached)
        cfg = Config(scan_backend="torch", device_batch=db)
        det = MVClusterDetector(360, 240, cfg)
        _, packed = random_packed(11, det, cfg)
        theirs = jax_det.scan_bits(packed)
        assert jax_det._bits_transposed
        np.testing.assert_array_equal(det.scan_bits(packed), theirs)

    def test_raw_mvs_overflow_raises(self):
        mvs = np.zeros((3, 16, 4), np.int16)
        counts = np.array([4, -40, 2], np.int32)
        with pytest.raises(ValueError, match="overflow"):
            MVClusterDetector(360, 240, Config(
                scan_backend="torch")).scan_raw_mvs(mvs, counts)
        with pytest.raises(ValueError, match="overflow"):
            JaxDetector(360, 240, JaxConfig()).scan_raw_mvs(mvs, counts)


_jax: dict = {}


def jax_bits_run(clip, tmp_path, **cfg_kw):
    """The JAX package's pipeline on the bits payload (XLA), once per
    clip and config: (seconds removed, saved %, heatmap or None)."""
    key = (clip, tuple(sorted(cfg_kw.items())))
    if key not in _jax:
        hp = str(tmp_path / "jax_heat.json")
        p = JaxPipeline(clip, str(tmp_path / "jax.mp4"), cfg=JaxConfig(
            device_batch=64, scan_backend="xla", heatmap_path=hp, **cfg_kw))
        assert p.run() == 0
        JaxTiming.clear()
        heat = None
        if os.path.exists(hp):
            with open(hp) as f:
                heat = json.load(f)
            heat.pop("input")
        _jax[key] = (p.time_removed, p.saved_pct, heat)
    return _jax[key]


class TestPipelineParity:
    def _run(self, clip, out, **cfg_kw):
        cfg = Config(device_batch=64, scan_backend="torch", **cfg_kw)
        p = ProcessingPipeline(clip, out, cfg=cfg)
        assert p.run() == 0
        TimingCollector.clear()
        return p.time_removed, p.saved_pct, os.path.getsize(out)

    def test_all_inputs_identical_cuts(self, clip, tmp_path):
        results = {inp: self._run(clip, str(tmp_path / f"out_{inp}.mp4"),
                                  scan_input=inp) for inp in INPUTS}
        assert len(set(results.values())) == 1
        assert results["bits"][:2] == jax_bits_run(clip, tmp_path)[:2]

    def test_mv_raw_overflow_rescan_exact(self, clip, tmp_path):
        ref = self._run(clip, str(tmp_path / "ref.mp4"), scan_input="grids",
                        metrics_json=str(tmp_path / "ref.jsonl"))
        ovf = self._run(clip, str(tmp_path / "ovf.mp4"),
                        scan_input="mv_raw", mv_capacity=8,
                        metrics_json=str(tmp_path / "ovf.jsonl"))
        assert ovf == ref
        assert ref[:2] == jax_bits_run(clip, tmp_path)[:2]
        ref_rec = json.loads(
            open(tmp_path / "ref.jsonl").read().splitlines()[-1])
        ovf_rec = json.loads(
            open(tmp_path / "ovf.jsonl").read().splitlines()[-1])
        for key in ("frames_scanned", "frames_with_mvs", "motion_frames"):
            assert ovf_rec[key] == ref_rec[key], (key, ovf_rec, ref_rec)

    def test_mv_raw_overflow_after_cap_resume_exact(self, clip, tmp_path,
                                                    monkeypatch):
        _, counts, _ = both_scans(clip, "scan_mvs", 0.0, 1e9,
                                  max_mv=1 << 16, max_frames=4096)
        cap = int(counts.max()) - 1
        assert counts[:32].max() <= cap, (counts[:32].max(), cap)
        events = []
        orig = native.VideoReader.scan_mvs

        def traced(self, *a, **kw):
            mvs, cnt, pts = orig(self, *a, **kw)
            events.append((bool(kw.get("resume")),
                           len(pts) > 0 and bool((cnt < 0).any())))
            return mvs, cnt, pts

        monkeypatch.setattr(native.VideoReader, "scan_mvs", traced)
        ref = self._run(clip, str(tmp_path / "ref.mp4"), scan_input="grids",
                        metrics_json=str(tmp_path / "ref.jsonl"))
        ovf = self._run(clip, str(tmp_path / "ovf.mp4"),
                        scan_input="mv_raw", mv_capacity=cap,
                        chunk_frames_cap=16,
                        metrics_json=str(tmp_path / "ovf.jsonl"))
        assert any(resume and overflowed for resume, overflowed in events)
        assert ovf == ref
        assert ref[:2] == jax_bits_run(clip, tmp_path)[:2]
        ref_rec = json.loads(
            open(tmp_path / "ref.jsonl").read().splitlines()[-1])
        ovf_rec = json.loads(
            open(tmp_path / "ovf.jsonl").read().splitlines()[-1])
        for key in ("frames_scanned", "frames_with_mvs", "motion_frames"):
            assert ovf_rec[key] == ref_rec[key], (key, ovf_rec, ref_rec)

    @pytest.mark.parametrize("knobs", [
        dict(width=328, height=200, vectors_needed=1, vertical_mask=0.0),
        dict(width=304, height=176, vectors_needed=4, clusters_needed=1),
        dict(width=640, height=352, mv_threshold_sq=4.0,
             vertical_mask=0.2, clusters_needed=3),
        dict(width=200, height=144, vectors_needed=0),
    ])
    def test_cross_input_parity_fuzz(self, tmp_path, knobs):
        knobs = dict(knobs)
        width = knobs.pop("width")
        height = knobs.pop("height")
        clip = str(tmp_path / f"f{width}x{height}.mp4")
        native.synthesize(clip, width=width, height=height, fps=25.0,
                          duration=10.0, codec="libx264",
                          motion_windows=((1.0, 3.0), (6.0, 7.0)), noise=2)
        results = {inp: self._run(clip, str(tmp_path / f"f_{inp}.mp4"),
                                  scan_input=inp, **knobs)[:2]
                   for inp in INPUTS}
        assert len(set(results.values())) == 1
        assert results["bits"] == jax_bits_run(clip, tmp_path, **knobs)[:2]

    def test_heatmap_identical_bits_vs_grids(self, clip, tmp_path):
        heats = {}
        for inp in ("bits", "words", "grids"):
            hp = str(tmp_path / f"heat_{inp}.json")
            self._run(clip, str(tmp_path / f"hout_{inp}.mp4"),
                      scan_input=inp, heatmap_path=hp)
            with open(hp) as f:
                heats[inp] = json.load(f)
            heats[inp].pop("input")
        assert heats["bits"] == heats["words"] == heats["grids"]
        assert heats["bits"] == jax_bits_run(clip, tmp_path)[2]
