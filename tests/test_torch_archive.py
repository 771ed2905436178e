"""mvtrim_tpu_torch's sharded archive scan vs the JAX package's.

The twins of tests/test_segmentation_op.py's TestArchiveScan,
TestArchiveCheckpoint, TestArchivePipelineEquivalence and
TestArchiveSADPayload: ``parallel.archive.scan_archive`` on the CPU build
(CPU shards) must give the JAX package's segments and stats (all but the
worker timings, and ``global_batch``/``dispatches`` on the SAD payload,
which the port sizes from unpadded luma) on the same synthesized clips,
exactly.  Also: a sidecar written by either package resumes in the other,
the ``ScanCheckpoint`` copy reads and writes what the original does, and
the reader-taking body (``scan_archive_reader``) over an in-test stand-in
reader equals the NumPy oracle, on the CPU here and on the card in the
``cuda``-marked test (``python -m pytest -m cuda
tests/test_torch_archive.py``).
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.models.sad_detector import SADDetector as JaxSAD
from mvtrim_tpu.parallel import archive as jax_archive
from mvtrim_tpu.parallel.mesh import build_mesh as jax_build_mesh
from mvtrim_tpu_torch.core import Config, GridGeometry, oracle
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.models.sad_detector import sad_oracle_counts
from mvtrim_tpu_torch.parallel import archive
from mvtrim_tpu_torch.parallel.archive import (ScanCheckpoint, scan_archive,
                                               scan_archive_reader)
from mvtrim_tpu_torch.parallel.mesh import build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH = dict(scan_backend="torch", chunk_duration_sec=5.0)
SAME_STATS = ("frames_scanned", "frames_with_mvs", "motion_frames",
              "payload", "mesh", "resumed_chunks")


def cpu_mesh(n):
    return build_mesh(n, device="cpu")


def spans(segs):
    return [(s.start, s.end) for s in segs]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("arch") / "long.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0,
                      duration=30.0, codec="libx264",
                      motion_windows=((3.0, 6.0), (20.0, 22.0)))
    return path


@pytest.fixture(scope="module")
def intra_clip(tmp_path_factory):
    """All-I-frame stream (gop=1): no codec MVs at all."""
    path = str(tmp_path_factory.mktemp("sadarch") / "intra.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0,
                      duration=20.0, codec="libx264", gop=1, noise=2,
                      motion_windows=((3.0, 6.0), (14.0, 16.0)))
    return path


_jax_runs: dict = {}


def jax_run(path, n, fpd, payload=None, **cfg):
    """The JAX package's scan_archive, once per argument set."""
    key = (path, n, fpd, payload, tuple(sorted(cfg.items())))
    if key not in _jax_runs:
        _jax_runs[key] = jax_archive.scan_archive(
            path, JaxConfig(chunk_duration_sec=5.0, **cfg),
            mesh=jax_build_mesh(n, sweep=1), frames_per_device=fpd,
            payload=payload)
    return _jax_runs[key]


def assert_same_run(ours, theirs, keys=SAME_STATS + ("dispatches",
                                                     "global_batch")):
    assert spans(ours[0]) == spans(theirs[0])
    assert ours[1] == theirs[1]
    for k in keys:
        assert ours[2][k] == theirs[2][k], k


class TestArchiveScan:
    def test_sharded_scan_matches_jax_and_single_device(self, clip):
        cfg = Config(**TORCH)
        ours8 = scan_archive(clip, cfg, mesh=cpu_mesh(8),
                             frames_per_device=32)
        assert_same_run(ours8, jax_run(clip, 8, 32))
        assert ours8[2]["mesh"]["data"] == 8
        assert ours8[2]["dispatches"] >= 2
        assert ours8[2]["worker_us"]["decode"] > 0
        ours1 = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                             frames_per_device=64)
        assert spans(ours1[0]) == spans(ours8[0])
        segs = ours8[0]
        assert len(segs) == 2
        assert segs[0].start < 6.0 and segs[0].end > 3.0
        assert segs[1].start < 22.0 and segs[1].end > 20.0

    def test_cli_archive_mode(self, clip, tmp_path, monkeypatch, capsys):
        """MVT_ARCHIVE=1 goes through run_archive; MVT_CHECKPOINT is
        honoured."""
        from mvtrim_tpu_torch.cli import main as cli_main

        ck = tmp_path / "cli.ckpt"
        for k, v in dict(MVT_ARCHIVE="1", MVT_SCAN_BACKEND="torch",
                         CHUNK_DURATION_SEC="5.0",
                         MVT_CHECKPOINT=str(ck)).items():
            monkeypatch.setenv(k, v)
        assert cli_main([clip, str(tmp_path / "o.mp4")]) == 0
        assert os.path.exists(tmp_path / "o.mp4")
        assert "Archive Scan" in capsys.readouterr().out
        assert sum('"chunk"' in line for line in open(ck)) == 6
        assert cli_main(["/nonexistent.mp4", str(tmp_path / "x.mp4")]) == 1


class TestArchiveCheckpoint:
    def test_resume_skips_chunks_and_matches(self, clip, tmp_path):
        cfg = Config(**TORCH)
        ck = str(tmp_path / "scan.ckpt")
        segs_a, _, stats_a = scan_archive(clip, cfg, mesh=cpu_mesh(2),
                                          frames_per_device=64,
                                          checkpoint=ck)
        assert stats_a["resumed_chunks"] == 0 and os.path.exists(ck)
        segs_b, _, stats_b = scan_archive(clip, cfg, mesh=cpu_mesh(2),
                                          frames_per_device=64,
                                          checkpoint=ck)
        assert stats_b["resumed_chunks"] == 6  # 30 s / 5 s chunks
        assert stats_b["frames_scanned"] == 0
        assert segs_b == segs_a

    def test_partial_checkpoint_resumes(self, clip, tmp_path):
        cfg = Config(**TORCH)
        ck_full = str(tmp_path / "full.ckpt")
        segs_full, _, _ = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                                       frames_per_device=64,
                                       checkpoint=ck_full)
        recs = [json.loads(x) for x in open(ck_full)]
        header = [r for r in recs if "header" in r]
        assert len(header) == 1
        chunks = sorted((r for r in recs if "chunk" in r),
                        key=lambda r: r["chunk"])
        ck_part = str(tmp_path / "part.ckpt")
        with open(ck_part, "w") as f:
            for r in header + chunks[:3]:
                f.write(json.dumps(r) + "\n")
        segs, _, stats = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                                      frames_per_device=64,
                                      checkpoint=ck_part)
        assert stats["resumed_chunks"] == 3
        assert segs == segs_full

    def test_legacy_headerless_sidecar_resumes_but_is_never_stamped(
            self, clip, tmp_path):
        cfg = Config(**TORCH)
        ck_full = str(tmp_path / "full.ckpt")
        segs_full, _, _ = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                                       frames_per_device=64,
                                       checkpoint=ck_full)
        legacy = str(tmp_path / "legacy.ckpt")
        with open(legacy, "w") as f:
            for line in open(ck_full):
                if "header" not in json.loads(line):
                    f.write(line)
        for _ in range(2):
            segs, _, stats = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                                          frames_per_device=64,
                                          checkpoint=legacy)
            assert stats["resumed_chunks"] == 6 and segs == segs_full
            assert not any("header" in json.loads(x) for x in open(legacy))

    def test_foreign_checkpoint_rejected(self, clip, tmp_path):
        ck = str(tmp_path / "scan.ckpt")
        scan_archive(clip, Config(**TORCH), mesh=cpu_mesh(1),
                     frames_per_device=64, checkpoint=ck)
        with pytest.raises(RuntimeError, match="different scan"):
            scan_archive(clip, Config(mv_threshold_sq=999, **TORCH),
                         mesh=cpu_mesh(1), frames_per_device=64,
                         checkpoint=ck)

    def test_sigkill_mid_scan_resumes(self, clip, tmp_path):
        """A scan SIGKILLed right after its 3rd chunk record must leave a
        sidecar that a fresh process resumes from, to the uninterrupted
        segments."""
        ck = str(tmp_path / "scan.ckpt")
        child = (
            "import os, signal\n"
            "import mvtrim_tpu_torch.parallel.archive as A\n"
            "from mvtrim_tpu_torch.core import Config\n"
            "from mvtrim_tpu_torch.parallel.mesh import build_mesh\n"
            "orig = A.ScanCheckpoint.record\n"
            "n = [0]\n"
            "def rec(self, cid, ts):\n"
            "    orig(self, cid, ts)\n"
            "    n[0] += 1\n"
            "    if n[0] == 3:\n"
            "        os.kill(os.getpid(), signal.SIGKILL)\n"
            "A.ScanCheckpoint.record = rec\n"
            f"A.scan_archive({clip!r}, Config(scan_backend='torch',\n"
            "               chunk_duration_sec=5.0),\n"
            "               mesh=build_mesh(1, device='cpu'),\n"
            f"               frames_per_device=64, checkpoint={ck!r})\n")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        p = subprocess.run([sys.executable, "-c", child], env=env,
                           capture_output=True, timeout=240)
        assert p.returncode == -signal.SIGKILL, p.stderr.decode()[-2000:]
        cfg = Config(**TORCH)
        segs_full, _, _ = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                                       frames_per_device=64)
        segs, _, stats = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                                      frames_per_device=64, checkpoint=ck)
        assert stats["resumed_chunks"] == 3
        assert segs == segs_full

    def test_truncated_tail_line_tolerated(self, clip, tmp_path):
        cfg = Config(**TORCH)
        ck = str(tmp_path / "scan.ckpt")
        segs_full, _, _ = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                                       frames_per_device=64, checkpoint=ck)
        with open(ck, "a") as f:
            f.write('{"chunk": 99, "motion_')  # torn write
        segs, _, stats = scan_archive(clip, cfg, mesh=cpu_mesh(1),
                                      frames_per_device=64, checkpoint=ck)
        assert stats["resumed_chunks"] == 6
        assert segs == segs_full


class TestSidecarAcrossPackages:
    @pytest.mark.parametrize("writer", ["jax", "torch"])
    @pytest.mark.parametrize("payload", ["bits", "sad"])
    def test_sidecar_resumes_in_the_other_package(
            self, clip, intra_clip, tmp_path, writer, payload):
        path = clip if payload == "bits" else intra_clip
        ck = str(tmp_path / f"{writer}.ckpt")
        jkw = dict(mesh=jax_build_mesh(2, sweep=1), frames_per_device=16,
                   checkpoint=ck, payload=payload)
        tkw = dict(mesh=cpu_mesh(2), frames_per_device=16, checkpoint=ck,
                   payload=payload)
        if writer == "jax":
            segs_w, _, _ = jax_archive.scan_archive(
                path, JaxConfig(chunk_duration_sec=5.0), **jkw)
            segs_r, _, stats = scan_archive(path, Config(**TORCH), **tkw)
        else:
            segs_w, _, _ = scan_archive(path, Config(**TORCH), **tkw)
            segs_r, _, stats = jax_archive.scan_archive(
                path, JaxConfig(chunk_duration_sec=5.0), **jkw)
        chunks = 6 if payload == "bits" else 4
        assert stats["resumed_chunks"] == chunks
        assert stats["frames_scanned"] == 0
        assert spans(segs_r) == spans(segs_w) and segs_r

    def test_checkpoint_copy_reads_and_writes_like_the_original(
            self, tmp_path):
        ident = {"input": "/v.mp4", "duration": 12.5, "frame_skip": 2}
        ours, theirs = str(tmp_path / "a"), str(tmp_path / "b")
        for cls, path in ((ScanCheckpoint, ours),
                          (jax_archive.ScanCheckpoint, theirs)):
            ck = cls(path, ident)
            ck.record(0, [0.04, 1 / 3])
            ck.record(2, [])
        assert open(ours).read() == open(theirs).read()
        assert ScanCheckpoint(theirs, ident).done == \
            jax_archive.ScanCheckpoint(ours, ident).done == \
            {0: [0.04, 1 / 3], 2: []}
        for cls, path in ((ScanCheckpoint, theirs),
                          (jax_archive.ScanCheckpoint, ours)):
            with pytest.raises(RuntimeError, match="different scan"):
                cls(path, dict(ident, frame_skip=1))


class TestArchivePipelineEquivalence:
    def test_archive_mode_matches_standard_pipeline(self, clip, tmp_path):
        """The archive scan and the port's standard pipeline emit the same
        cut list (the concat list a fake ffmpeg dumps)."""
        cfg = Config(scan_backend="oracle", chunk_duration_sec=5.0)
        segs, dur, _ = scan_archive(clip, cfg, mesh=cpu_mesh(4),
                                    frames_per_device=64)
        dump = str(tmp_path / "std.txt")
        env = dict(os.environ,
                   MVT_FFMPEG_BIN=os.path.join(REPO, "parity",
                                               "fake_ffmpeg.sh"),
                   MVT_CONCAT_DUMP=dump, MVT_SCAN_BACKEND="torch",
                   CHUNK_DURATION_SEC="5.0", MVT_LOG="0",
                   PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        subprocess.run([sys.executable, "-m", "mvtrim_tpu_torch", clip,
                        str(tmp_path / "std.mp4")], env=env, cwd=REPO,
                       check=True, capture_output=True, timeout=240)
        _, out_segments = oracle.decide_cut(segs, dur, cfg.min_savings_pct)
        assert oracle.concat_list(os.path.abspath(clip), out_segments) == \
            open(dump).read()


def _sad_truth(path: str):
    """The JAX SADDetector run chunk by chunk (the single-device truth of
    tests/test_segmentation_op.py:307) -> segments."""
    import math

    cfg = JaxConfig(chunk_duration_sec=5.0)
    with native.VideoReader(path) as reader:
        duration, fps = reader.duration, reader.fps
        det = JaxSAD(reader.width, reader.height, cfg)
        cap = int(math.ceil(cfg.chunk_duration_sec * max(fps, 1.0))) + 64
        cur = native.ChunkScanCursor(duration, cfg.chunk_duration_sec, cap)
        carry, ts = None, []
        while cur.more():
            start, end = cur.window()
            if not cur.resume:
                carry = None
            data, pts = reader.scan_luma(start, end, max_frames=cap,
                                         resume=cur.resume)
            cur.advance(len(pts))
            if len(pts) == 0:
                continue
            ts.extend(pts[det.scan_luma(data, carry=carry)].tolist())
            carry = data[-1].copy()
    return oracle.segments_from_timestamps(
        oracle.merge_timestamps(ts), max_gap_sec=cfg.max_gap_sec,
        padding_sec=cfg.padding_sec, duration=duration)


class TestArchiveSADPayload:
    def test_auto_selects_sad_and_matches_jax(self, intra_clip):
        ours = scan_archive(intra_clip, Config(**TORCH), mesh=cpu_mesh(8),
                            frames_per_device=8)
        assert ours[2]["payload"] == "sad" and ours[2]["dispatches"] >= 2
        assert_same_run(ours, jax_run(intra_clip, 8, 8), SAME_STATS)
        segs = ours[0]
        assert spans(segs) == spans(_sad_truth(intra_clip))
        assert len(segs) == 2
        assert segs[0].start < 6.0 and segs[0].end > 3.0
        assert segs[1].start < 16.0 and segs[1].end > 14.0

    def test_auto_keeps_bits_on_mv_stream(self, clip):
        _, _, stats = scan_archive(clip, Config(**TORCH), mesh=cpu_mesh(2),
                                   frames_per_device=32)
        assert stats["payload"] == "bits"

    @pytest.mark.parametrize("n", [1, 4])
    def test_mesh_sizes_agree(self, intra_clip, n):
        segs, _, stats = scan_archive(intra_clip, Config(**TORCH),
                                      mesh=cpu_mesh(n), frames_per_device=16,
                                      payload="sad")
        assert stats["payload"] == "sad"
        assert spans(segs) == spans(jax_run(intra_clip, 8, 8)[0])

    @pytest.mark.parametrize("n,fpd", [(4, 8), (3, 5)])
    def test_part_streaming_is_decision_invariant(self, intra_clip, n, fpd):
        """A tiny frame cap forces many parts per chunk, interleaved
        across decode workers (the placeholder-row path): the decisions do
        not move, and equal the JAX scan's at the same cap."""
        ours = scan_archive(intra_clip,
                            Config(chunk_frames_cap=16, **TORCH),
                            mesh=cpu_mesh(n), frames_per_device=fpd,
                            payload="sad", decode_workers=3)
        theirs = jax_run(intra_clip, 4, 8, "sad", chunk_frames_cap=16)
        assert spans(ours[0]) == spans(theirs[0]) == \
            spans(jax_run(intra_clip, 8, 8)[0])
        assert ours[2]["motion_frames"] == theirs[2]["motion_frames"]

    def test_sad_checkpoint_resume(self, intra_clip, tmp_path):
        cfg = Config(**TORCH)
        ck = str(tmp_path / "sad.ckpt")
        kw = dict(mesh=cpu_mesh(2), frames_per_device=16, checkpoint=ck,
                  payload="sad")
        segs_a, _, stats_a = scan_archive(intra_clip, cfg, **kw)
        assert stats_a["resumed_chunks"] == 0
        segs_b, _, stats_b = scan_archive(intra_clip, cfg, **kw)
        assert stats_b["resumed_chunks"] == 4   # 20 s / 5 s chunks
        assert stats_b["frames_scanned"] == 0
        assert segs_b == segs_a

    def test_payload_mismatched_sidecar_refuses(self, intra_clip, tmp_path):
        ck = str(tmp_path / "x.ckpt")
        kw = dict(mesh=cpu_mesh(1), frames_per_device=16, checkpoint=ck)
        scan_archive(intra_clip, Config(**TORCH), payload="sad", **kw)
        with pytest.raises(RuntimeError, match="different scan"):
            scan_archive(intra_clip, Config(**TORCH), payload="bits", **kw)

    def test_forced_bits_on_intra_warns_and_finds_nothing(self, intra_clip,
                                                          capsys):
        segs, _, stats = scan_archive(intra_clip, Config(**TORCH),
                                      mesh=cpu_mesh(1), frames_per_device=32,
                                      payload="bits")
        assert stats["payload"] == "bits" and segs == []
        captured = capsys.readouterr()
        assert "MV side data" in captured.out + captured.err

    def test_unknown_payload_raises(self, clip):
        with pytest.raises(ValueError, match="unknown archive payload"):
            scan_archive(clip, Config(**TORCH), mesh=cpu_mesh(1),
                         payload="grids")


class StandInReader:
    """A seeded stand-in for ``native.VideoReader``: 12 s at 25 fps of
    320x240 activity masks (noise cells that never cluster, a blob inside
    WINDOWS) and luma (a static textured background, +-2 noise, a bright
    box moving inside WINDOWS).  Scans serve [start, end), at most
    ``max_frames``, and with ``resume`` go on after the last frame
    served."""

    WINDOWS = ((1.0, 3.0), (9.0, 10.0))
    _data: dict = {}

    def __init__(self, seed: int = 0):
        self.width, self.height, self.fps, self.duration = 320, 240, 25.0, 12.0
        self.pts = np.arange(300) / 25.0
        if seed not in self._data:
            self._data[seed] = self._make(seed)
        self.active, self.bits, self.luma = self._data[seed]
        self.next = 0

    def _make(self, seed: int):
        rng = np.random.default_rng(seed)
        geom = GridGeometry.build(320, 240, Config())
        moving = np.zeros(300, bool)
        for lo, hi in self.WINDOWS:
            moving |= (self.pts >= lo) & (self.pts < hi)
        lattice = np.zeros((geom.gh, geom.gw), bool)
        lattice[::2, ::2] = True
        active = lattice & (rng.random((300, geom.gh, geom.gw)) < 0.1)
        for i in np.nonzero(moving)[0]:
            x = 2 + i % (geom.gw - 8)
            active[i, 5:9, x:x + 5] = True
        base = rng.integers(30, 200, size=(240, 320)).astype(np.int16)
        noise = rng.integers(-2, 3, size=(300, 240, 320)).astype(np.int16)
        luma = base + noise
        for i in np.nonzero(moving)[0]:
            x = 8 * i % 240
            luma[i, 80:140, x:x + 64] = 255
        return (active, np.packbits(active, axis=2, bitorder="little"),
                np.clip(luma, 0, 255).astype(np.uint8))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass

    def _range(self, start, end, max_frames, resume):
        lo = self.next if resume else int(np.searchsorted(self.pts, start))
        hi = min(lo + max_frames, int(np.searchsorted(self.pts, end)))
        self.next = hi
        return lo, hi

    def scan_bits(self, start, end, *, frame_skip=1, max_frames=4096,
                  timing=None, resume=False, **geometry):
        assert frame_skip == 1
        lo, hi = self._range(start, end, max_frames, resume)
        if timing is not None:
            timing.frames_with_mvs += hi - lo
        return self.bits[lo:hi], self.pts[lo:hi]

    def scan_luma(self, start, end, *, frame_skip=1, max_frames=256,
                  timing=None, resume=False):
        lo, hi = self._range(start, end, max_frames, resume)
        return self.luma[lo:hi], self.pts[lo:hi]


def stand_in_truth(payload: str, chunk: float = 5.0):
    """NumPy decisions over the stand-in: the cluster rule on the masks,
    or the SAD contract chunk by chunk (a chunk's first frame never
    motion) -> segments."""
    r = StandInReader()
    cfg = Config(chunk_duration_sec=chunk)
    geom = GridGeometry.build(r.width, r.height, cfg)
    if payload == "bits":
        counts = oracle.count_clusters_batch(
            r.active.astype(np.uint8), vectors_needed=1, y_min=geom.y_min,
            y_max=geom.y_max)
        motion = counts >= oracle.effective_clusters_needed(
            cfg.clusters_needed)
    else:
        motion = np.zeros(len(r.pts), bool)
        per = int(chunk * r.fps)
        for c0 in range(0, len(r.pts), per):
            lum = r.luma[c0:c0 + per]
            counts = sad_oracle_counts(lum, geom,
                                       sad_threshold=cfg.sad_threshold,
                                       block_size=cfg.block_size)
            motion[c0 + 1:c0 + len(lum)] = counts >= \
                oracle.effective_clusters_needed(cfg.clusters_needed)
    ts = oracle.merge_timestamps(r.pts[motion].tolist())
    return oracle.segments_from_timestamps(
        ts, max_gap_sec=cfg.max_gap_sec, padding_sec=cfg.padding_sec,
        duration=r.duration)


@pytest.mark.parametrize("payload", ["bits", "sad", "auto"])
def test_reader_body_matches_the_oracle(payload, monkeypatch):
    """The auto case takes the default mesh, which follows the config's
    backend (one CPU shard for the CPU build), whatever the environment
    asks for."""
    monkeypatch.setenv("MVT_SCAN_BACKEND", "auto")
    segs, dur, stats = scan_archive_reader(
        StandInReader, Config(**TORCH), name="stand-in",
        mesh=None if payload == "auto" else cpu_mesh(2),
        frames_per_device=16, payload=payload, decode_workers=2)
    truth = stand_in_truth("sad" if payload == "sad" else "bits")
    assert spans(segs) == spans(truth) and len(truth) == 2
    assert stats["frames_scanned"] == 300 and dur == 12.0
    assert stats["mesh"]["data"] == (1 if payload == "auto" else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["bits", "sad"])
def test_cuda_archive_matches_cpu_and_oracle(payload):
    """World size 1 on the card: the same segments and stats as the CPU
    build and the NumPy oracle, the kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_archive.py)")
    from mvtrim_tpu_torch.ops import cluster as cluster_ops

    kw = dict(name="stand-in", frames_per_device=16, payload=payload,
              decode_workers=2)
    before = cluster_ops.cluster_words_op.launches + \
        cluster_ops.cluster_map_op.launches
    ours = scan_archive_reader(StandInReader, Config(chunk_duration_sec=5.0),
                               mesh=build_mesh(1, device="cuda"), **kw)
    assert cluster_ops.cluster_words_op.launches + \
        cluster_ops.cluster_map_op.launches > before
    ref = scan_archive_reader(StandInReader, Config(**TORCH),
                              mesh=cpu_mesh(1), **kw)
    assert spans(ours[0]) == spans(ref[0]) == \
        spans(stand_in_truth(payload))
    for k in SAME_STATS + ("dispatches", "global_batch"):
        assert ours[2][k] == ref[2][k], k


def test_identity_is_the_jax_packages(clip, tmp_path):
    """The sidecar headers both packages write for one scan are equal."""
    heads = []
    for name, run in (("t", lambda ck: scan_archive(
            clip, Config(**TORCH), mesh=cpu_mesh(1), checkpoint=ck)),
                      ("j", lambda ck: jax_archive.scan_archive(
                          clip, JaxConfig(chunk_duration_sec=5.0),
                          mesh=jax_build_mesh(1, sweep=1), checkpoint=ck))):
        ck = str(tmp_path / name)
        run(ck)
        heads.append(json.loads(open(ck).readline()))
    assert heads[0] == heads[1] and heads[0]["header"]["input"] == \
        os.path.abspath(clip)
    assert archive._identity(os.path.abspath(clip), 30.0, Config(**TORCH),
                             1, "bits").keys() == heads[0]["header"].keys()
