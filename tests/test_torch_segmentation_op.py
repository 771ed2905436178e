"""Twin of tests/test_segmentation_op.py on the port's CPU build.

Every case of the JAX suite, fed the same streams or the same synthesized
clips: ``ops.segmentation.segment_op`` against the JAX package's
``make_segment_op`` (starts, ends and counts exact; the kept seconds to
float32 rounding, as the JAX suite holds them to the oracle), and the
sharded archive scan (``parallel.archive.scan_archive``, CPU shards)
against the JAX package's on the same clip, segments exact, with each
case's own assertions on the port's result.  The clips are shorter than
the JAX suite's (20 s and 12 s), so the chunk counts differ from its.
"""

import json
import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.ops.segmentation import make_segment_op
from mvtrim_tpu.parallel import archive as jax_archive
from mvtrim_tpu.parallel.mesh import build_mesh as jax_mesh
from mvtrim_tpu_torch.core import Config, oracle
from mvtrim_tpu_torch.core.types import TimeSegment
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.ops.segmentation import segment_op
from mvtrim_tpu_torch.parallel.archive import scan_archive
from mvtrim_tpu_torch.parallel.mesh import build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 5.0
MV_SEC = 20.0         # 4 chunks
INTRA_SEC = 12.0      # 3 chunks


def run_both(ts_motion, duration, max_gap=5.0, pad=0.5, cap=16):
    """Both ops on one stream: (port segments, port kept); the JAX op's
    starts, ends and count must equal the port's."""
    ts = np.asarray([t for t, _ in ts_motion], np.float32)
    motion = np.asarray([m for _, m in ts_motion], bool)
    j_starts, j_ends, j_count, j_kept = make_segment_op(
        cap, max_gap_sec=max_gap, padding_sec=pad)(
            ts, motion, np.float32(duration))
    starts, ends, count, kept = segment_op(
        torch.from_numpy(ts), torch.from_numpy(motion)[:, None], duration,
        max_segments=cap, max_gap_sec=max_gap, padding_sec=pad)
    n = int(count[0])
    assert n == int(j_count)
    np.testing.assert_array_equal(starts[0].numpy(), np.asarray(j_starts))
    np.testing.assert_array_equal(ends[0].numpy(), np.asarray(j_ends))
    assert float(kept[0]) == pytest.approx(float(j_kept), rel=1e-6)
    return ([TimeSegment(round(float(s), 4), round(float(e), 4))
             for s, e in zip(starts[0, :n].tolist(), ends[0, :n].tolist())],
            float(kept[0]))


class TestSegmentOp:
    def test_matches_oracle_basic(self):
        pts = [10.0, 11.0, 12.0, 20.0, 21.0]
        segs, kept = run_both([(t, True) for t in pts], 100.0)
        expect = oracle.segments_from_timestamps(
            pts, max_gap_sec=5.0, padding_sec=0.5, duration=100.0)
        assert segs == expect
        assert kept == pytest.approx(sum(s.end - s.start for s in expect))

    def test_non_motion_frames_ignored(self):
        stream = [(9.0, False), (10.0, True), (10.5, False), (11.0, True),
                  (30.0, False), (40.0, True)]
        segs, _ = run_both(stream, 100.0)
        assert segs == oracle.segments_from_timestamps(
            [10.0, 11.0, 40.0], max_gap_sec=5.0, padding_sec=0.5,
            duration=100.0)

    def test_no_motion(self):
        segs, kept = run_both([(1.0, False), (2.0, False)], 10.0)
        assert segs == [] and kept == 0.0

    def test_clamping(self):
        segs, _ = run_both([(0.2, True), (9.9, True)], 10.0, max_gap=2.0)
        assert segs == oracle.segments_from_timestamps(
            [0.2, 9.9], max_gap_sec=2.0, padding_sec=0.5, duration=10.0)

    def test_random_streams_match_oracle(self, rng):
        for _ in range(10):
            ts = np.unique(np.sort(rng.uniform(0, 300, 64)).astype(
                np.float32))
            motion = rng.random(len(ts)) < 0.3
            segs, _ = run_both(list(zip(ts.tolist(), motion.tolist())),
                               300.0, max_gap=7.0, pad=1.0, cap=64)
            expect = oracle.segments_from_timestamps(
                ts[motion].astype(np.float64), max_gap_sec=7.0,
                padding_sec=1.0, duration=300.0)
            assert len(segs) == len(expect)
            for got, want in zip(segs, expect):
                assert got.start == pytest.approx(want.start, abs=1e-3)
                assert got.end == pytest.approx(want.end, abs=1e-3)

    def test_capacity_saturation_keeps_first(self):
        stream = [(float(10 * i), True) for i in range(20)]
        segs, _ = run_both(stream, 1000.0, max_gap=2.0, cap=4)
        assert len(segs) == 4
        assert segs == oracle.segments_from_timestamps(
            [10.0 * i for i in range(20)], max_gap_sec=2.0,
            padding_sec=0.5, duration=1000.0)[:4]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("arch") / "long.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0,
                      duration=MV_SEC, codec="libx264",
                      motion_windows=((3.0, 6.0), (14.0, 16.0)))
    return path


@pytest.fixture(scope="module")
def intra_clip(tmp_path_factory):
    """All-I-frame stream (gop=1): no codec MVs at all."""
    path = str(tmp_path_factory.mktemp("sadarch") / "intra.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0,
                      duration=INTRA_SEC, codec="libx264", gop=1, noise=2,
                      motion_windows=((1.5, 3.0), (9.5, 11.0)))
    return path


_jax: dict = {}


def jax_scan(path, n=1, fpd=64, payload=None, **cfg):
    """The JAX package's archive scan, once per argument set."""
    key = (path, n, fpd, payload, tuple(sorted(cfg.items())))
    if key not in _jax:
        _jax[key] = jax_archive.scan_archive(
            path, JaxConfig(chunk_duration_sec=CHUNK, **cfg),
            mesh=jax_mesh(n, sweep=1), frames_per_device=fpd,
            payload=payload)
    return _jax[key]


def ours(path, n=1, fpd=64, **kw):
    cfg = Config(**{"scan_backend": "torch", "chunk_duration_sec": CHUNK,
                    **kw.pop("cfg", {})})
    return scan_archive(path, cfg, mesh=build_mesh(n, device="cpu"),
                        frames_per_device=fpd, **kw)


def spans(segs):
    return [(s.start, s.end) for s in segs]


class TestArchiveScan:
    def test_sharded_scan_matches_single_device(self, clip):
        segs8, dur, stats = ours(clip, 8, 32)
        j8 = jax_scan(clip, 8, 32)
        assert spans(segs8) == spans(j8[0]) and dur == j8[1]
        assert stats["mesh"]["data"] == 8
        assert stats["dispatches"] >= 2
        assert stats["worker_us"]["decode"] > 0
        assert stats["worker_us"]["analyze"] >= 0
        segs1, _, _ = ours(clip, 1, 64)
        assert segs8 == segs1
        assert len(segs8) == 2
        assert segs8[0].start < 6.0 and segs8[0].end > 3.0
        assert segs8[1].start < 16.0 and segs8[1].end > 14.0


class TestArchiveCheckpoint:
    def test_resume_skips_chunks_and_matches(self, clip, tmp_path):
        ck = str(tmp_path / "scan.ckpt")
        segs_a, _, stats_a = ours(clip, 2, checkpoint=ck)
        assert stats_a["resumed_chunks"] == 0 and os.path.exists(ck)
        segs_b, _, stats_b = ours(clip, 2, checkpoint=ck)
        assert stats_b["resumed_chunks"] == math.ceil(MV_SEC / CHUNK)
        assert stats_b["frames_scanned"] == 0
        assert segs_b == segs_a
        assert spans(segs_b) == spans(jax_scan(clip, 2)[0])

    def test_partial_checkpoint_resumes(self, clip, tmp_path):
        ck_full = str(tmp_path / "full.ckpt")
        segs_full, _, _ = ours(clip, checkpoint=ck_full)
        recs = [json.loads(x) for x in open(ck_full)]
        header = [r for r in recs if "header" in r]
        assert len(header) == 1
        chunks = sorted((r for r in recs if "chunk" in r),
                        key=lambda r: r["chunk"])
        ck_part = str(tmp_path / "part.ckpt")
        with open(ck_part, "w") as f:
            for r in header + chunks[:3]:
                f.write(json.dumps(r) + "\n")
        segs, _, stats = ours(clip, checkpoint=ck_part)
        assert stats["resumed_chunks"] == 3
        assert segs == segs_full
        assert spans(segs) == spans(jax_scan(clip)[0])

    def test_legacy_headerless_sidecar_resumes_but_is_never_stamped(
            self, clip, tmp_path):
        ck_full = str(tmp_path / "full.ckpt")
        segs_full, _, _ = ours(clip, checkpoint=ck_full)
        legacy = str(tmp_path / "legacy.ckpt")
        with open(legacy, "w") as f:
            for line in open(ck_full):
                if "header" not in json.loads(line):
                    f.write(line)
        for _ in range(2):
            segs, _, stats = ours(clip, checkpoint=legacy)
            assert stats["resumed_chunks"] == math.ceil(MV_SEC / CHUNK)
            assert segs == segs_full
            assert not any("header" in json.loads(x) for x in open(legacy))
        assert spans(segs_full) == spans(jax_scan(clip)[0])

    def test_foreign_checkpoint_rejected(self, clip, tmp_path):
        ck = str(tmp_path / "scan.ckpt")
        ours(clip, checkpoint=ck)
        with pytest.raises(RuntimeError, match="different scan"):
            ours(clip, checkpoint=ck, cfg=dict(mv_threshold_sq=999))

    def test_sigkill_mid_scan_resumes(self, clip, tmp_path):
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
            f"               chunk_duration_sec={CHUNK}),\n"
            "               mesh=build_mesh(1, device='cpu'),\n"
            f"               frames_per_device=64, checkpoint={ck!r})\n")
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        p = subprocess.run([sys.executable, "-c", child], env=env,
                           capture_output=True, timeout=240)
        assert p.returncode == -signal.SIGKILL, p.stderr.decode()[-2000:]
        segs, _, stats = ours(clip, checkpoint=ck)
        assert stats["resumed_chunks"] == 3
        assert spans(segs) == spans(jax_scan(clip)[0])

    def test_truncated_tail_line_tolerated(self, clip, tmp_path):
        ck = str(tmp_path / "scan.ckpt")
        segs_full, _, _ = ours(clip, checkpoint=ck)
        with open(ck, "a") as f:
            f.write('{"chunk": 99, "motion_')  # torn write
        segs, _, stats = ours(clip, checkpoint=ck)
        assert stats["resumed_chunks"] == math.ceil(MV_SEC / CHUNK)
        assert segs == segs_full
        assert spans(segs) == spans(jax_scan(clip)[0])


class TestArchivePipelineEquivalence:
    def test_archive_mode_matches_standard_pipeline(self, clip, tmp_path):
        """The port's archive scan cut as the port's standard pipeline
        cuts the clip (fake-ffmpeg concat dump), and as the JAX
        package's archive scan decides it."""
        segs, dur, _ = ours(clip, 4, cfg=dict(scan_backend="oracle"))
        dump = str(tmp_path / "std.txt")
        env = dict(os.environ,
                   MVT_FFMPEG_BIN=os.path.join(REPO, "parity",
                                               "fake_ffmpeg.sh"),
                   MVT_CONCAT_DUMP=dump, MVT_SCAN_BACKEND="oracle",
                   CHUNK_DURATION_SEC=str(CHUNK), MVT_LOG="0")
        subprocess.run([sys.executable, "-m", "mvtrim_tpu_torch", clip,
                        str(tmp_path / "std.mp4")], env=env, cwd=REPO,
                       check=True, capture_output=True, timeout=300)
        _, out_segments = oracle.decide_cut(segs, dur, 5.0)
        assert oracle.concat_list(os.path.abspath(clip),
                                  out_segments) == open(dump).read()
        assert spans(segs) == spans(jax_scan(clip, 4)[0])


class TestArchiveSADPayload:
    def test_auto_selects_sad_and_matches_single_device_truth(
            self, intra_clip):
        segs, dur, stats = ours(intra_clip, 8, 8)
        assert stats["payload"] == "sad"
        assert stats["dispatches"] >= 2
        j = jax_scan(intra_clip, 8, 8)
        assert j[2]["payload"] == "sad"
        assert spans(segs) == spans(j[0]) and dur == j[1]
        assert len(segs) == 2
        assert segs[0].start < 3.0 and segs[0].end > 1.5
        assert segs[1].start < 11.0 and segs[1].end > 9.5

    def test_auto_keeps_bits_on_mv_stream(self, clip):
        _, _, stats = ours(clip, 2, 32)
        assert stats["payload"] == "bits"
        assert jax_scan(clip, 2, 32)[2]["payload"] == "bits"

    @pytest.mark.parametrize("n", [1, 4])
    def test_mesh_sizes_agree(self, intra_clip, n):
        segs, _, stats = ours(intra_clip, n, 16, payload="sad")
        assert stats["payload"] == "sad"
        assert spans(segs) == spans(jax_scan(intra_clip, 8, 8)[0])

    def test_part_streaming_is_decision_invariant(self, intra_clip):
        segs, _, _ = ours(intra_clip, 4, 8, payload="sad",
                          cfg=dict(chunk_frames_cap=16))
        assert spans(segs) == spans(jax_scan(intra_clip, 8, 8)[0])

    def test_sad_checkpoint_resume(self, intra_clip, tmp_path):
        ck = str(tmp_path / "sad.ckpt")
        segs_a, _, stats_a = ours(intra_clip, 2, 16, checkpoint=ck,
                                  payload="sad")
        assert stats_a["resumed_chunks"] == 0
        segs_b, _, stats_b = ours(intra_clip, 2, 16, checkpoint=ck,
                                  payload="sad")
        assert stats_b["resumed_chunks"] == math.ceil(INTRA_SEC / CHUNK)
        assert stats_b["frames_scanned"] == 0
        assert segs_b == segs_a
        assert spans(segs_b) == spans(jax_scan(intra_clip, 8, 8)[0])

    def test_payload_mismatched_sidecar_refuses(self, intra_clip,
                                                tmp_path):
        ck = str(tmp_path / "x.ckpt")
        ours(intra_clip, 1, 16, checkpoint=ck, payload="sad")
        with pytest.raises(RuntimeError, match="different scan"):
            ours(intra_clip, 1, 16, checkpoint=ck, payload="bits")

    def test_forced_bits_on_intra_warns_and_finds_nothing(
            self, intra_clip, capsys):
        segs, _, stats = ours(intra_clip, 1, 32, payload="bits")
        assert stats["payload"] == "bits"
        assert segs == []
        assert jax_scan(intra_clip, 1, 32, payload="bits")[0] == []
        captured = capsys.readouterr()
        assert "MV side data" in captured.out + captured.err
