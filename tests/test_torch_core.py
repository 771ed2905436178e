"""mvtrim_tpu_torch's copies of the framework-free layers vs the originals.

The port keeps its own ``core`` (config, types, oracle), ``io.native``,
``cut.executor`` and ``utils``, copied from ``mvtrim_tpu``.  These tests
hold each copy to its original: one environment configures both packages
alike, the geometries and oracle decisions agree exactly, both native
bridges scan a clip into identical arrays, and both cut executors write
identical bytes.
"""

import dataclasses
import re

import numpy as np
import pytest

from mvtrim_tpu.core import config as jax_config
from mvtrim_tpu.core import oracle as jax_oracle
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.core.types import TimeSegment as JaxSegment
from mvtrim_tpu.cut import executor as jax_executor
from mvtrim_tpu.io import native as jax_native
from mvtrim_tpu.utils import system as jax_system
from mvtrim_tpu_torch.core import config as torch_config
from mvtrim_tpu_torch.core import oracle as torch_oracle
from mvtrim_tpu_torch.core.types import GridGeometry, TimeSegment
from mvtrim_tpu_torch.cut import executor as torch_executor
from mvtrim_tpu_torch.io import native as torch_native
from mvtrim_tpu_torch.utils import system as torch_system

ENV_NAMES = sorted(set(re.findall(
    r'_env_\w+\("(\w+)"', open(jax_config.__file__).read())))
# one value each that differs from its default and parses for its type
ENV_VALUES = {"bool": "1", "int": "7", "float": "3.25", "str": "grids"}
GEOMETRIES = [(640, 480, 0.05), (360, 240, 0.0), (200, 144, 0.05),
              (320, 16, 0.0), (96, 32, 0.0), (1920, 1080, 0.05),
              (3840, 2160, 0.05), (1000, 562, 0.05), (7680, 4320, 0.1)]


def fields(cfg):
    return dataclasses.asdict(cfg)


def test_env_names_are_found():
    assert len(ENV_NAMES) >= 30
    assert {"VECTORS_NEEDED", "MVT_MV_CAPACITY", "MVT_SCAN_INPUT"} <= set(
        ENV_NAMES)
    assert open(torch_config.__file__).read().count("_env_") == \
        open(jax_config.__file__).read().count("_env_")


def test_defaults_match(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    assert fields(torch_config.Config.from_env()) == \
        fields(jax_config.Config.from_env())
    assert fields(torch_config.Config()) == fields(jax_config.Config())


@pytest.mark.parametrize("name", ENV_NAMES)
def test_every_env_name_matches(monkeypatch, name):
    kind = re.search(rf'_env_(\w+)\("{name}"',
                     open(jax_config.__file__).read()).group(1)
    monkeypatch.setenv(name, ENV_VALUES[kind])
    ours = torch_config.Config.from_env()
    assert fields(ours) == fields(jax_config.Config.from_env())
    assert fields(ours) != fields(torch_config.Config())


@pytest.mark.parametrize("raw,wrapped", [("256", 0), ("-1", 255),
                                         ("255", 255), ("257", 1)])
def test_vectors_needed_wraps_like_uint8(monkeypatch, raw, wrapped):
    monkeypatch.setenv("VECTORS_NEEDED", raw)
    assert torch_config.Config.from_env().vectors_needed == wrapped == \
        jax_config.Config.from_env().vectors_needed
    v = int(raw)
    assert torch_config.Config(vectors_needed=v).vectors_needed == wrapped \
        == jax_config.Config(vectors_needed=v).vectors_needed


@pytest.mark.parametrize("dims", GEOMETRIES)
def test_grid_geometry_matches(dims):
    w, h, vm = dims
    ours = GridGeometry.build(w, h, torch_config.Config(vertical_mask=vm))
    theirs = JaxGeometry.build(w, h, jax_config.Config(vertical_mask=vm))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.padded_gh, ours.padded_gw) == (theirs.padded_gh,
                                                 theirs.padded_gw)


def test_system_helpers_match():
    assert torch_system.parse_cpuset_list("0-3,8,10-11") == \
        jax_system.parse_cpuset_list("0-3,8,10-11")
    assert torch_system.detect_cpu_limit() == jax_system.detect_cpu_limit()
    assert torch_system.calculate_parallel_streams(3) == \
        jax_system.calculate_parallel_streams(3)
    for name in ("device_info", "enable_compile_cache",
                 "apply_platform_override"):
        assert not hasattr(torch_system, name)


class TestOracle:
    @pytest.mark.parametrize("seed", range(4))
    def test_frame_decisions(self, seed):
        rng = np.random.default_rng(seed)
        mvs = np.concatenate([
            rng.integers(-40, 700, size=(300, 2)),
            rng.integers(-40, 700, size=(300, 2))], 1)
        mvs[:4] = (32767, 32767, -32768, -32768)
        kw = dict(threshold_sq=16.0, block_shift=4, y_min=1, y_max=29)
        np.testing.assert_array_equal(
            torch_oracle.vote_grid(mvs, 40, 30, **kw),
            jax_oracle.vote_grid(mvs, 40, 30, **kw))
        for vn in (0, 1, 2, 255):
            assert torch_oracle.check_frame(
                mvs, 40, 30, vectors_needed=vn, clusters_needed=2, **kw) == \
                jax_oracle.check_frame(mvs, 40, 30, vectors_needed=vn,
                                       clusters_needed=2, **kw)
        grids = rng.integers(0, 4, size=(5, 30, 40)).astype(np.uint8)
        for vn in (0, 2):
            np.testing.assert_array_equal(
                torch_oracle.count_clusters_batch(
                    grids, vectors_needed=vn, y_min=1, y_max=29),
                jax_oracle.count_clusters_batch(
                    grids, vectors_needed=vn, y_min=1, y_max=29))
            assert torch_oracle.count_clusters(
                grids[0], vectors_needed=vn, y_min=1, y_max=29) == \
                jax_oracle.count_clusters(grids[0], vectors_needed=vn,
                                          y_min=1, y_max=29)

    @pytest.mark.parametrize("seed", range(4))
    def test_segments_and_cut(self, seed):
        rng = np.random.default_rng(seed)
        ts = rng.random(200) * 100
        ours = torch_oracle.merge_timestamps(ts)
        np.testing.assert_array_equal(ours, jax_oracle.merge_timestamps(ts))
        kw = dict(max_gap_sec=float(rng.random() * 5), padding_sec=0.5,
                  duration=99.0)
        segs = torch_oracle.segments_from_timestamps(ours, **kw)
        jsegs = jax_oracle.segments_from_timestamps(ours, **kw)
        assert [(s.start, s.end) for s in segs] == \
            [(s.start, s.end) for s in jsegs]
        assert torch_oracle.savings(segs, 99.0) == \
            jax_oracle.savings(jsegs, 99.0)
        for pct in (5.0, 99.0):
            cut, out = torch_oracle.decide_cut(segs, 99.0, pct)
            jcut, jout = jax_oracle.decide_cut(jsegs, 99.0, pct)
            assert cut == jcut and [(s.start, s.end) for s in out] == \
                [(s.start, s.end) for s in jout]
        assert torch_oracle.concat_list("/a.mp4", segs) == \
            jax_oracle.concat_list("/a.mp4", jsegs)
        assert torch_oracle.effective_clusters_needed(0) == \
            jax_oracle.effective_clusters_needed(0)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("core") / "clip.mp4")
    jax_native.synthesize(path, width=320, height=240, fps=25.0,
                          duration=6.0, codec="libx264",
                          motion_windows=((1.0, 2.5), (4.0, 5.0)))
    return path


class TestNative:
    def test_the_library_is_the_repos(self):
        assert torch_native._NATIVE_DIR == jax_native._NATIVE_DIR

    def test_scans_are_identical(self, clip):
        geom = dict(gw=20, gh=15, y_min=0, y_max=15)
        with torch_native.VideoReader(clip) as a, \
                jax_native.VideoReader(clip) as b:
            assert (a.duration, a.fps, a.width, a.height) == \
                (b.duration, b.fps, b.width, b.height)
            for scan, kw in [
                    ("scan_bits", dict(threshold_sq=16.0, block_shift=4,
                                       vectors_needed=2, **geom)),
                    ("scan_grids", dict(threshold_sq=16.0, block_shift=4,
                                        **geom)),
                    ("scan_mvs", dict(max_mv=512)),
                    ("scan_grids_multi", dict(thresholds_sq=[4.0, 16.0],
                                              block_shift=4, **geom))]:
                ours = getattr(a, scan)(0.0, 6.0, **kw)
                theirs = getattr(b, scan)(0.0, 6.0, **kw)
                assert len(ours) == len(theirs)
                for x, y in zip(ours, theirs):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
        with torch_native.VideoReader(clip, torch_native.MVT_MODE_LUMA) as a,\
                jax_native.VideoReader(clip, jax_native.MVT_MODE_LUMA) as b:
            for x, y in zip(a.scan_luma(0.0, 2.0), b.scan_luma(0.0, 2.0)):
                np.testing.assert_array_equal(x, y)


def test_execute_cut_writes_identical_bytes(clip, tmp_path):
    segs = [(0.5, 2.5), (3.96, 5.5)]
    ours, theirs = str(tmp_path / "ours.mp4"), str(tmp_path / "theirs.mp4")
    assert torch_executor.execute_cut(
        clip, ours, [TimeSegment(*s) for s in segs], -1,
        torch_config.Config()) == 0
    assert jax_executor.execute_cut(
        clip, theirs, [JaxSegment(*s) for s in segs], -1,
        jax_config.Config()) == 0
    data = open(ours, "rb").read()
    assert len(data) > 1000 and data == open(theirs, "rb").read()
    assert torch_executor.quantized_segments(
        [TimeSegment(*s) for s in segs]) == jax_executor.quantized_segments(
            [JaxSegment(*s) for s in segs])
