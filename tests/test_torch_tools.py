"""mvtrim_tpu_torch's tools vs the JAX package's (tests/test_tools.py).

``extract_mvs``, ``motion_scalar`` and ``heatmap`` are copies of the JAX
package's jax-free tools: on the same clip they must return the same
documents, exactly.  ``device_probe`` reports the CUDA inventory, and
``doctor`` replaces the JAX checks with the CUDA inventory, ``nvcc``, the
kernel library and the port's mesh: a missing card, ``nvcc`` or libav is
a failed check, never a crash.
"""

import json

import numpy as np
import pytest
import torch

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.tools import extract_mvs as jax_extract
from mvtrim_tpu.tools import heatmap as jax_heatmap
from mvtrim_tpu.tools import motion_scalar as jax_scalar
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.ops import _build
from mvtrim_tpu_torch.tools import (device_probe, doctor, extract_mvs,
                                    heatmap, motion_scalar)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tools") / "m.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=6.0,
                      codec="libx264", motion_windows=((1.0, 3.0),))
    return path


@pytest.fixture(scope="module")
def doc(clip):
    return extract_mvs.extract(clip)


class TestExtractMVs:
    def test_schema(self, clip, doc):
        assert doc["input"] == clip
        frames = doc["frames"]
        assert len(frames) > 100
        assert [f["frame_index"] for f in frames] == \
            list(range(1, len(frames) + 1))
        assert frames[0]["frame_type"] == "I" and frames[0]["num_mvs"] == 0
        p = next(f for f in frames
                 if f["num_mvs"] > 0 and 1.0 <= (f["pts_seconds"] or 0) < 3.0)
        mv = p["motion_vectors"][0]
        assert set(mv) == {"dst_x", "dst_y", "src_x", "src_y", "w", "h",
                           "motion_x", "motion_y", "motion_scale", "source"}
        scale = mv["motion_scale"] or 1
        assert mv["src_x"] == pytest.approx(
            mv["dst_x"] + mv["motion_x"] / scale, abs=1e-3)

    def test_matches_jax(self, clip, doc):
        assert doc == jax_extract.extract(clip)

    def test_cli_writes_json(self, clip, tmp_path):
        ours, theirs = str(tmp_path / "a.json"), str(tmp_path / "b.json")
        assert extract_mvs.main([clip, ours]) == 0
        assert jax_extract.main([clip, theirs]) == 0
        assert open(ours).read() == open(theirs).read()

    def test_usage(self):
        assert extract_mvs.main([]) == 1


class TestMotionScalar:
    def test_buckets_match_jax(self, doc):
        buckets = motion_scalar.motion_per_second(doc)
        assert buckets == jax_scalar.motion_per_second(doc)
        moving = sum(buckets.get(s, 0.0) for s in (1, 2))
        still = sum(buckets.get(s, 0.0) for s in (4, 5))
        assert moving > 10 * max(still, 1e-9)

    def test_hand_built_doc(self):
        doc = {"frames": [
            {"pts_seconds": 0.5, "motion_vectors": [
                {"motion_x": 4, "motion_y": 0, "motion_scale": 4,
                 "w": 16, "h": 16},
                {"motion_x": 3, "motion_y": 4, "motion_scale": 0,
                 "w": 16, "h": 16}]},
            {"pts_seconds": None, "motion_vectors": [
                {"motion_x": 99, "motion_y": 0, "motion_scale": 1,
                 "w": 16, "h": 16}]},
            {"pts_seconds": 1.9, "motion_vectors": [
                {"motion_x": 0, "motion_y": 8, "motion_scale": 2,
                 "w": 8, "h": 8}]},
        ]}
        assert motion_scalar.motion_per_second(doc) == \
            {0: pytest.approx(256.0), 1: pytest.approx(256.0)}

    def test_cli(self, clip, tmp_path, capsys):
        out = str(tmp_path / "mvs.json")
        extract_mvs.main([clip, out])
        assert motion_scalar.main([out]) == 0
        ours = capsys.readouterr()
        assert jax_scalar.main([out]) == 0
        theirs = capsys.readouterr()
        assert ours.out == theirs.out
        assert ours.out.startswith("second,motion_value")
        assert "PERFORMANCE METRICS" in ours.err
        assert motion_scalar.main([]) == 1


class TestHeatmap:
    @pytest.mark.parametrize("vec", [2, 0])
    def test_matches_jax(self, clip, vec):
        ours, frames, geom = heatmap.compute_heatmap(
            clip, Config(vectors_needed=vec))
        theirs, jframes, jgeom = jax_heatmap.compute_heatmap(
            clip, JaxConfig(vectors_needed=vec))
        np.testing.assert_array_equal(ours, theirs)
        assert frames == jframes > 100
        assert (geom.gh, geom.gw) == (jgeom.gh, jgeom.gw)
        if vec == 0:
            # every cell of an MV frame active, MV-less frames only in
            # the denominator
            assert np.allclose(ours, ours[0, 0]) and 0 < ours[0, 0] < 1
        else:
            band = ours[geom.gh // 3: 2 * geom.gh // 3].mean()
            assert band > 10 * max(ours[:2].mean(), 1e-9)

    def test_cli_json(self, clip, tmp_path, capsys):
        npy = str(tmp_path / "h.npy")
        assert heatmap.main([clip, "--npy", npy]) == 0
        ours = json.loads(capsys.readouterr().out)
        assert jax_heatmap.main([clip]) == 0
        assert ours == json.loads(capsys.readouterr().out)
        assert ours["grid"] == [15, 20] and ours["hottest_cells"]
        assert np.load(npy).shape == (15, 20)


class TestDeviceProbe:
    def test_probe_json(self, capsys):
        assert device_probe.main([]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["devices"] == device_probe.cuda_devices()
        assert doc["scan_geometry_1080p"]["grid"] == [68, 120]
        assert doc["scan_geometry_1080p"]["bytes_per_frame"] == 68 * 15
        assert doc["host"]["cpu_limit"] >= 1

    def test_inventory_of_a_card(self, monkeypatch):
        class Props:
            name, multi_processor_count = "NVIDIA H100 80GB HBM3", 132
            total_memory, major, minor = 85 << 30, 9, 0

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: Props)
        assert device_probe.cuda_devices() == [{
            "index": 0, "name": "NVIDIA H100 80GB HBM3", "sm_count": 132,
            "memory_bytes": 85 << 30, "capability": "9.0"}]


def by_name(results):
    return {r["name"]: r for r in results}


class TestDoctor:
    def test_media_checks_pass_on_this_box(self, monkeypatch):
        monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
        checks = by_name(doctor.run_checks())
        for required in ("native-library", "h264-mv-export", "remux-cut",
                         "device-mesh", "end-to-end (torch)"):
            assert checks[required]["status"] == "ok", checks[required]
        assert checks["hevc-mv-export"]["status"] in ("ok", "warn")
        assert checks["libav"]["detail"].startswith("avformat")
        assert "cpu" in checks["device-mesh"]["detail"]
        assert list(checks)[5:8] == ["cuda-devices", "nvcc",
                                     "kernel-library"]

    def test_missing_card_and_nvcc_fail_without_raising(self, monkeypatch,
                                                        capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
        monkeypatch.setattr(_build, "_lib", None)
        monkeypatch.setenv("MVT_SCAN_BACKEND", "auto")
        checks = by_name(doctor.run_checks())
        for name in ("cuda-devices", "nvcc", "kernel-library",
                     "device-mesh"):
            assert checks[name]["status"] == "fail", checks[name]
        assert "nvcc not found" in checks["nvcc"]["detail"]
        assert "no CUDA device" in checks["cuda-devices"]["detail"]
        rc = doctor.main([])
        out = capsys.readouterr().out
        assert rc >= 4 and "[FAIL] nvcc" in out
        assert f"{rc} failures" in out.splitlines()[-1]

    @pytest.mark.parametrize("backend", [None, "oracle"])
    def test_end_to_end_follows_the_scan_backend(self, monkeypatch, backend):
        """The end-to-end trim runs on MVT_SCAN_BACKEND: by default on the
        card (auto), a failed check where there is none; on the NumPy
        oracle when asked."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        if backend is None:
            monkeypatch.delenv("MVT_SCAN_BACKEND", raising=False)
        else:
            monkeypatch.setenv("MVT_SCAN_BACKEND", backend)
        checks = by_name(doctor.run_checks())
        e2e = checks[f"end-to-end ({backend or 'auto'})"]
        assert e2e["status"] == ("fail" if backend is None else "ok"), e2e

    def test_missing_libav_fails_without_raising(self, monkeypatch, capsys):
        """The card's machine has no FFmpeg libraries: every media check
        fails, the report still comes out, and --json counts them."""
        def no_lib():
            raise OSError("libavformat.so.59: cannot open shared object")

        monkeypatch.setattr(native, "_load_library", no_lib)
        monkeypatch.setattr(native, "_hevc_mv_capable", None)
        monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
        rc = doctor.main(["--json"])
        doc = json.loads(capsys.readouterr().out)
        checks = by_name(doc["checks"])
        for name in ("native-library", "libav", "h264-mv-export",
                     "remux-cut", "end-to-end (torch)"):
            assert checks[name]["status"] == "fail", checks[name]
        assert "libavformat" in checks["libav"]["detail"]
        assert checks["device-mesh"]["status"] == "ok"
        assert rc == doc["failures"] >= 5


class TestDoctorKernelCache:
    """``kernel-cache``: ok when the library for these sources is in its
    directory (MVT_COMPILE_CACHE), warn when it is not but ``nvcc`` is there
    (first use builds it) or this process just built it, fail when neither;
    and a missing ``nvcc`` is a warn, not a fail, beside a prebuilt
    library (the runtime image)."""

    @pytest.fixture
    def cache(self, monkeypatch, tmp_path):
        monkeypatch.setenv("MVT_COMPILE_CACHE", str(tmp_path))
        monkeypatch.setattr(_build, "build_info", {})
        return tmp_path

    @staticmethod
    def nvcc(monkeypatch, present: bool):
        def found():
            return "/usr/local/cuda/bin/nvcc"

        def missing():
            raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")

        monkeypatch.setattr(_build, "_nvcc", found if present else missing)

    @pytest.mark.parametrize("prebuilt,nvcc,built_here,status", [
        (True, False, False, "ok"),
        (True, True, False, "ok"),
        (False, True, False, "warn"),
        (True, True, True, "warn"),
        (False, False, False, "fail"),
    ])
    def test_status(self, monkeypatch, cache, prebuilt, nvcc, built_here,
                    status):
        self.nvcc(monkeypatch, nvcc)
        path = _build.library_path()
        if prebuilt:
            open(path, "wb").close()
        if built_here:
            _build.build_info.update(seconds=1.0, path=path, report="")
        check = doctor._check_kernel_cache()
        assert check["name"] == "kernel-cache"
        assert check["status"] == status, check
        assert str(cache) in check["detail"]

    @pytest.mark.parametrize("prebuilt,status", [(True, "warn"),
                                                 (False, "fail")])
    def test_missing_nvcc_is_a_warn_beside_a_prebuilt_library(
            self, monkeypatch, cache, prebuilt, status):
        self.nvcc(monkeypatch, False)
        monkeypatch.setattr(_build, "_lib", None)
        if prebuilt:
            open(_build.library_path(), "wb").close()
        monkeypatch.setattr(doctor, "_check_e2e", lambda backend: {
            "name": f"end-to-end ({backend})", "status": "ok", "detail": ""})
        checks = by_name(doctor.run_checks())
        assert checks["nvcc"]["status"] == status, checks["nvcc"]
        assert "nvcc not found" in checks["nvcc"]["detail"]
        assert checks["kernel-cache"]["status"] == ("ok" if prebuilt
                                                   else "fail")
        names = list(checks)
        assert names.index("kernel-cache") == \
            names.index("kernel-library") + 1
