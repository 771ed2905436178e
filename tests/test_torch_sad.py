"""mvtrim_tpu_torch block-SAD op, SADDetector and the SAD scan vs JAX.

Seeded numpy luma goes through the port's plain PyTorch build (``sad_op``
on CPU tensors, unpadded) and through the JAX package (``make_sad_op_xla``
and ``make_sad_op_pallas`` in interpret mode, both on ``pad_luma`` input)
and the NumPy ``sad_oracle_counts``.  Block sums are exact integers, so
the tolerance is exact equality.  The CUDA kernels are checked by the
``cuda``-marked test (``python -m pytest -m cuda tests/test_torch_sad.py``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvtrim_tpu.core.config import Config
from mvtrim_tpu.core.types import GridGeometry
from mvtrim_tpu.io import native
from mvtrim_tpu.models.sad_detector import SADDetector as JaxSADDetector
from mvtrim_tpu.models.sad_detector import \
    sad_oracle_counts as jax_sad_oracle_counts
from mvtrim_tpu.ops import sad as jax_sad
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline as JaxPipeline
from mvtrim_tpu.utils.timing import TimingCollector
from mvtrim_tpu_torch.cli import main as cli_main
from mvtrim_tpu_torch.models.sad_detector import SADDetector, \
    sad_oracle_counts
from mvtrim_tpu_torch.ops import sad as torch_sad
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = Config()
BS = CFG.block_size
BOUND = torch_sad.sad_threshold_sum(CFG.sad_threshold, BS)  # 3072
DIMS = [(320, 240), (1000, 562), (200, 150), (3840, 96)]


@pytest.fixture(scope="module")
def intra_clip(tmp_path_factory):
    """All-I-frame clip (gop=1): decodes fine, exports zero MVs."""
    path = str(tmp_path_factory.mktemp("sad") / "intra.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=10.0,
                      codec="libx264", motion_windows=((2.0, 4.0),), gop=1)
    return path


@pytest.fixture(autouse=True)
def clear_timing():
    TimingCollector.clear()
    yield
    TimingCollector.clear()


def near_threshold_luma(seed, n, width, height, bound=BOUND):
    """uint8 [n, H, W]: frame i+1 differs from frame i by a block SAD of
    exactly bound-1, bound, bound+1 or 0 in each block (partial edge
    blocks included), with the sign of each pixel's difference mixed.
    A pixel differs by at most 128, so one sign always stays in 0..255;
    a partial block too small to reach its target at that stays below."""
    rng = np.random.default_rng(seed)
    gh, gw = -(-height // BS), -(-width // BS)
    luma = np.empty((n, height, width), np.uint8)
    luma[0] = rng.integers(40, 216, size=(height, width))
    for i in range(1, n):
        target = rng.choice([bound - 1, bound, bound + 1, 0], size=(gh, gw))
        diff = np.zeros((height, width), np.int16)
        for by in range(gh):
            for bx in range(gw):
                blk = diff[by * BS:(by + 1) * BS, bx * BS:(bx + 1) * BS]
                px = blk.size
                t = min(max(0, int(target[by, bx])), 128 * px)
                base, rem = divmod(t, px)
                flat = np.full(px, base, np.int16)
                flat[:rem] += 1
                blk[...] = rng.permutation(flat).reshape(blk.shape)
        prev = luma[i - 1].astype(np.int16)
        sign = np.where(rng.random((height, width)) < 0.5, -1, 1)
        cur = prev + sign * diff
        cur = np.where((cur < 0) | (cur > 255), prev - sign * diff, cur)
        luma[i] = cur.astype(np.uint8)
    return luma


def jax_counts(luma, geom, sad_threshold=CFG.sad_threshold):
    op = jax_sad.make_sad_op_xla(geom, sad_threshold=sad_threshold,
                                 block_size=BS,
                                 clusters_needed=CFG.clusters_needed)
    counts, motion = op(jax_sad.pad_luma(luma, geom, BS))
    return np.asarray(counts), np.asarray(motion)


@pytest.mark.parametrize("dims", DIMS)
class TestAgainstJax:
    def test_near_threshold_matches_xla_and_oracle(self, dims):
        geom = GridGeometry.build(*dims, CFG)
        luma = near_threshold_luma(dims[0] + dims[1], 4, *dims)
        counts, motion = torch_sad.sad_op(
            torch.from_numpy(luma), geom, sad_threshold=CFG.sad_threshold,
            block_size=BS, clusters_needed=CFG.clusters_needed)
        assert counts.dtype == torch.int32 and motion.dtype == torch.bool
        expect, expect_motion = jax_counts(luma, geom)
        np.testing.assert_array_equal(counts.numpy(), expect)
        np.testing.assert_array_equal(motion.numpy(), expect_motion)
        kw = dict(sad_threshold=CFG.sad_threshold, block_size=BS)
        np.testing.assert_array_equal(
            sad_oracle_counts(luma, geom, **kw), expect)
        np.testing.assert_array_equal(
            jax_sad_oracle_counts(luma, geom, **kw), expect)
        assert expect.any()

    def test_threshold_zero(self, dims):
        """MVT_SAD_THRESHOLD=0: every block is active, static or not."""
        geom = GridGeometry.build(*dims, CFG)
        luma = np.full((3, dims[1], dims[0]), 77, np.uint8)
        cfg = Config(sad_threshold=0.0)
        counts, _ = torch_sad.sad_op(
            torch.from_numpy(luma), geom, sad_threshold=0.0, block_size=BS,
            clusters_needed=cfg.clusters_needed)
        expect, _ = jax_counts(luma, geom, sad_threshold=0.0)
        np.testing.assert_array_equal(counts.numpy(), expect)
        assert (expect > 0).all()

    def test_block_grid_is_exact_block_sums(self, dims):
        """The plain grid against a numpy sum of each block, partial edge
        blocks summing only their in-frame pixels."""
        luma = near_threshold_luma(dims[0], 3, *dims)
        grid = torch_sad.sad_block_grid_plain(torch.from_numpy(luma), BS)
        h, w = dims[1], dims[0]
        gh, gw = -(-h // BS), -(-w // BS)
        assert grid.dtype == torch.int32 and grid.shape == (2, gh, gw)
        d = np.abs(luma[1:].astype(np.int64) - luma[:-1])
        padded = np.zeros((2, gh * BS, gw * BS), np.int64)
        padded[:, :h, :w] = d
        expect = padded.reshape(2, gh, BS, gw, BS).sum(axis=(2, 4))
        np.testing.assert_array_equal(grid.numpy(), expect)
        assert set(np.unique(expect[:, :h // BS, :w // BS])) <= {
            0, BOUND - 1, BOUND, BOUND + 1}


def test_matches_pallas_interpret():
    """The TPU kernel this op replaces (make_sad_op_pallas), in interpret
    mode, at several frames per step (padded tail included)."""
    geom = GridGeometry.build(320, 240, CFG)
    luma = near_threshold_luma(3, 8, 320, 240)
    counts, motion = torch_sad.sad_op(
        torch.from_numpy(luma), geom, sad_threshold=CFG.sad_threshold,
        block_size=BS, clusters_needed=CFG.clusters_needed)
    for fps_n in (1, 3):
        op = jax_sad.make_sad_op_pallas(
            geom, sad_threshold=CFG.sad_threshold, block_size=BS,
            clusters_needed=CFG.clusters_needed, height=240, width=320,
            interpret=True, frames_per_step=fps_n)
        p_counts, p_motion = op(jax_sad.pad_luma(luma, geom, BS))
        np.testing.assert_array_equal(np.asarray(p_counts), counts.numpy())
        np.testing.assert_array_equal(np.asarray(p_motion), motion.numpy())


def test_matches_pallas_sliced_k7():
    """The lane-sliced 4K variant (make_sad_kernel_sliced, which
    make_sad_op_pallas picks at F=1 on a 256-lane-aligned grid): one CUDA
    kernel covers it, so the port must equal it at its geometry."""
    geom = GridGeometry.build(3840, 96, CFG)
    op = jax_sad.make_sad_op_pallas(
        geom, sad_threshold=CFG.sad_threshold, block_size=BS,
        clusters_needed=CFG.clusters_needed, height=96, width=3840,
        interpret=True, frames_per_step=1)
    assert op.slices_per_frame == 2
    luma = near_threshold_luma(5, 5, 3840, 96)
    p_counts, p_motion = op(jax_sad.pad_luma(luma, geom, BS))
    counts, motion = torch_sad.sad_op(
        torch.from_numpy(luma), geom, sad_threshold=CFG.sad_threshold,
        block_size=BS, clusters_needed=CFG.clusters_needed)
    np.testing.assert_array_equal(np.asarray(p_counts), counts.numpy())
    np.testing.assert_array_equal(np.asarray(p_motion), motion.numpy())
    assert np.asarray(p_counts).any()


def test_helpers_match_jax():
    for thr in (0.0, 0.5, 12.0, 12.001, 255.0):
        assert torch_sad.sad_threshold_sum(thr, BS) == \
            jax_sad.sad_threshold_sum(thr, BS)
    geom = GridGeometry.build(1000, 562, CFG)
    luma = np.random.default_rng(0).integers(0, 256, (2, 562, 1000),
                                             dtype=np.uint8)
    assert torch_sad.pad_luma(luma, geom, BS).tobytes() == \
        jax_sad.pad_luma(luma, geom, BS).tobytes()


class TestWrapper:
    GEOM = GridGeometry.build(320, 240, CFG)
    KW = dict(sad_threshold=CFG.sad_threshold, block_size=BS,
              clusters_needed=CFG.clusters_needed)

    def test_cpu_tensor_runs_plain_and_counts_no_launch(self):
        before = torch_sad.sad_op.launches
        counts, motion = torch_sad.sad_op(
            torch.zeros((3, 240, 320), dtype=torch.uint8), self.GEOM,
            **self.KW)
        assert torch_sad.sad_op.launches == before
        assert counts.tolist() == [0, 0] and not motion.any()

    @pytest.mark.parametrize("bad", ["dtype", "shape", "grid", "stride",
                                     "device"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        luma = torch.zeros((3, 240, 320), dtype=torch.uint8)
        if bad == "dtype":
            luma = luma.to(torch.int16)
        elif bad == "shape":
            luma = torch.zeros((240, 320), dtype=torch.uint8)
        elif bad == "grid":
            luma = torch.zeros((3, 240, 352), dtype=torch.uint8)
        elif bad == "stride":
            luma = torch.zeros((3, 320, 240), dtype=torch.uint8).transpose(
                1, 2)
        else:
            luma = luma.to("meta")
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            torch_sad.sad_op(luma, self.GEOM, **self.KW)

    def test_vector_width_follows_pitch_and_alignment(self):
        buf = torch.zeros(3 * 240 * 320 + 16, dtype=torch.uint8)
        assert torch_sad._vector_width(buf[:3 * 240 * 320].view(
            3, 240, 320), BS) == 16
        assert torch_sad._vector_width(buf[4:4 + 3 * 240 * 320].view(
            3, 240, 320), BS) == 4
        assert torch_sad._vector_width(buf[1:1 + 3 * 240 * 320].view(
            3, 240, 320), BS) == 1
        assert torch_sad._vector_width(
            torch.zeros((2, 562, 1000), dtype=torch.uint8), BS) == 4
        with pytest.raises(ValueError):
            torch_sad._vector_width(
                torch.zeros((2, 64, 63), dtype=torch.uint8), 64)


class TestSADDetector:
    def luma_seq(self, seed, n=12):
        """320x240: a moving bright square on odd frames < 8 (each pair
        differs -> motion), then a static tail (no motion)."""
        rng = np.random.default_rng(seed)
        luma = np.zeros((n, 240, 320), np.uint8)
        luma[:] = rng.integers(0, 200, size=(240, 320), dtype=np.uint8)
        for i in range(1, min(n, 8), 2):
            luma[i, 40:120, 20 + i * 12:120 + i * 12] = 255
        return luma

    @pytest.mark.parametrize("n", [1, 8, 9, 12])
    def test_matches_jax_detector(self, n):
        """device_batch 64 // 8 = 8 frames per window: N = 1, a window, a
        window + 1, with and without carry."""
        ours = SADDetector(320, 240, Config(scan_backend="torch",
                                            device_batch=64))
        assert ours.device_batch == 8
        theirs = JaxSADDetector(320, 240, Config(scan_backend="xla",
                                                 device_batch=64))
        luma = self.luma_seq(n, n=max(n, 2))[:n]
        carry = self.luma_seq(n + 1)[0]
        carry[100:140, 100:200] = 255
        np.testing.assert_array_equal(ours.scan_luma(luma),
                                      theirs.scan_luma(luma))
        with_carry = ours.scan_luma(luma, carry=carry)
        np.testing.assert_array_equal(
            with_carry, theirs.scan_luma(luma, carry=carry))
        assert with_carry[0]  # the carry differs from frame 0
        assert not ours.scan_luma(luma)[0]

    def test_carry_matches_single_scan(self):
        """Splitting a chunk anywhere and threading the boundary frame as
        ``carry`` reproduces single-scan decisions exactly."""
        luma = self.luma_seq(1234)
        n = len(luma)
        det = SADDetector(320, 240, Config(scan_backend="torch",
                                           device_batch=64))
        full = det.scan_luma(luma)
        assert full[1:8].all() and not full[9:].any()
        for k in (1, 2, 5, 9, n - 1):
            head = det.scan_luma(luma[:k])
            tail = det.scan_luma(luma[k:], carry=luma[k - 1])
            np.testing.assert_array_equal(np.concatenate([head, tail]), full,
                                          err_msg=f"split at {k}")

    def test_backends(self, monkeypatch):
        """oracle maps to the plain versions; auto needs a card."""
        det = SADDetector(320, 240, Config(scan_backend="oracle"),
                          device="cuda:1")
        assert det.backend == "torch" and det.device == torch.device("cpu")
        luma = self.luma_seq(3)
        np.testing.assert_array_equal(
            det.scan_luma(luma),
            SADDetector(320, 240, Config(scan_backend="torch")).scan_luma(
                luma))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="MVT_SCAN_BACKEND=torch"):
            SADDetector(320, 240, Config())

    def test_detects_moving_box(self, intra_clip):
        with native.VideoReader(intra_clip, native.MVT_MODE_LUMA) as r:
            luma, pts = r.scan_luma(0.0, r.duration, max_frames=300)
        motion = SADDetector(320, 240, Config(
            scan_backend="torch")).scan_luma(luma)
        assert not motion[0]
        hits = pts[motion]
        assert len(hits) > 10
        assert all(1.9 <= p <= 4.1 for p in hits), hits


def run_pair(clip, tmp_path, tag, **kw):
    """The port (plain build) and the JAX pipeline (XLA build) on one
    clip: (ours, theirs, motion frames and scanned frames of each)."""
    out = {}
    for name, cls, backend in (("ours", ProcessingPipeline, "torch"),
                               ("theirs", JaxPipeline, "xla")):
        metrics = str(tmp_path / f"{tag}_{name}.jsonl")
        p = cls(clip, str(tmp_path / f"{tag}_{name}.mp4"), cfg=Config(
            scan_backend=backend, metrics_json=metrics, **kw))
        assert p.run() == 0
        rec = json.loads(open(metrics).read().splitlines()[-1])
        out[name] = (p, rec)
    return out


def output_duration(path):
    if not os.path.exists(path):
        return None
    with native.VideoReader(path) as r:
        return r.duration


class TestPipeline:
    @pytest.mark.parametrize("mode", ["auto", "sad"])
    def test_matches_jax_pipeline(self, intra_clip, tmp_path, mode):
        """MVT_PIPELINE=auto falls back to SAD on the MV-less clip;
        MVT_PIPELINE=sad goes there directly."""
        runs = run_pair(intra_clip, tmp_path, mode, pipeline_mode=mode)
        (ours, rec_o), (theirs, rec_t) = runs["ours"], runs["theirs"]
        assert (ours.time_removed, ours.saved_pct) == \
            (theirs.time_removed, theirs.saved_pct)
        assert 50.0 < ours.saved_pct < 80.0
        for key in ("motion_frames", "frames_scanned", "decision"):
            assert rec_o[key] == rec_t[key], key
        assert "parallel_scan[sad]" in rec_o["phases_us"]
        d = output_duration(str(tmp_path / f"{mode}_ours.mp4"))
        assert d == output_duration(str(tmp_path / f"{mode}_theirs.mp4"))
        assert d is not None and 1.0 < d < 6.0
        with native.VideoReader(intra_clip) as r:
            fps, w, h = r.fps, r.width, r.height
        assert sorted(ours._parallel_scan("sad", fps, w, h).motion_ts) == \
            sorted(theirs._parallel_scan("sad", fps, w, h).motion_ts)

    def test_frame_cap_identical_cut(self, intra_clip, tmp_path):
        """MVT_CHUNK_FRAMES_CAP=8 forces ~30 cap-resumes, several inside
        the motion window; the threaded carry keeps every decision."""
        capped = run_pair(intra_clip, tmp_path, "capped",
                          pipeline_mode="sad", chunk_frames_cap=8)
        plain = run_pair(intra_clip, tmp_path, "uncapped",
                         pipeline_mode="sad")
        ours, rec = capped["ours"]
        ref, ref_rec = plain["ours"]
        assert rec["motion_frames"] > 0
        assert (ours.time_removed, ours.saved_pct, rec["motion_frames"],
                rec["frames_scanned"]) == \
            (ref.time_removed, ref.saved_pct, ref_rec["motion_frames"],
             ref_rec["frames_scanned"])
        theirs, rec_t = capped["theirs"]
        assert (ours.saved_pct, rec["motion_frames"]) == \
            (theirs.saved_pct, rec_t["motion_frames"])

    def test_mv_mode_finds_nothing(self, intra_clip, tmp_path):
        runs = run_pair(intra_clip, tmp_path, "mv", pipeline_mode="mv")
        for name in ("ours", "theirs"):
            assert runs[name][1]["decision"] == "no_motion"
            assert not os.path.exists(str(tmp_path / f"mv_{name}.mp4"))

    def test_cli_default_config_on_mv_less_clip(self, intra_clip, tmp_path,
                                                monkeypatch):
        """python -m mvtrim_tpu_torch under the default MVT_PIPELINE=auto
        exits 0 on an MV-less clip and writes the trimmed copy."""
        monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
        monkeypatch.delenv("MVT_PIPELINE", raising=False)
        out = str(tmp_path / "cli.mp4")
        assert cli_main([intra_clip, out]) == 0
        assert 1.0 < output_duration(out) < 6.0


def test_every_module_imports_without_jax():
    """A fresh interpreter imports every module of the port and never
    imports jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mvtrim_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'mvtrim_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'mvtrim_tpu_torch.models.sad_detector' in names, names\n"
        "assert 'mvtrim_tpu_torch.ops.sad' in names, names\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('JAX_FREE', len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX_FREE" in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1920, 1080), (3840, 2160), (320, 240),
                                  (1000, 562), (3840, 96), (1001, 97)])
def test_cuda_kernels_match_plain(dims):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_sad.py)")
    geom = GridGeometry.build(*dims, CFG)
    kw = dict(sad_threshold=CFG.sad_threshold, block_size=BS,
              clusters_needed=CFG.clusters_needed)
    for b in (1, 9):
        luma = torch.from_numpy(near_threshold_luma(b, b + 1, *dims))
        before = torch_sad.sad_op.launches
        counts, motion = torch_sad.sad_op(luma.cuda(), geom, **kw)
        torch.cuda.synchronize()
        assert torch_sad.sad_op.launches == before + 1
        expect, expect_motion = torch_sad.sad_op(luma, geom, **kw)
        np.testing.assert_array_equal(counts.cpu().numpy(), expect.numpy())
        np.testing.assert_array_equal(motion.cpu().numpy(),
                                      expect_motion.numpy())
        # a base address off 16-byte alignment takes narrower loads
        buf = torch.zeros(luma.numel() + 1, dtype=torch.uint8,
                          device="cuda")
        shifted = buf[1:].view(luma.shape)
        shifted.copy_(luma.cuda())
        np.testing.assert_array_equal(
            torch_sad.sad_op(shifted, geom, **kw)[0].cpu().numpy(),
            expect.numpy())
