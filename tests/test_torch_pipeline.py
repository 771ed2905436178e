"""mvtrim_tpu_torch pipeline, batch mode and CLI on synthetic clips.

The port's plain PyTorch build (``scan_backend="torch"``) must reach the
same motion timestamps and cut decision as the JAX pipeline (XLA build),
for the bits, words and grids payloads, and ``MVT_ARCHIVE=1`` the same
output as the JAX CLI's archive scan.  The SAD scan has its own file, test_torch_sad.py.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import pytest
import torch

from mvtrim_tpu.cli import main as jax_cli_main
from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline as JaxPipeline
from mvtrim_tpu.utils.timing import TimingCollector as JaxTiming
from mvtrim_tpu_torch.batch.batch import BatchProcessor, list_videos
from mvtrim_tpu_torch.cli import main as cli_main
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.utils.timing import TimingCollector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH = Config(scan_backend="torch")


@pytest.fixture(scope="module")
def motion_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pipe") / "motion.mp4")
    native.synthesize(path, width=640, height=480, fps=25.0, duration=20.0,
                      codec="libx264",
                      motion_windows=((2.0, 5.0), (12.0, 14.0)))
    return path


@pytest.fixture(scope="module")
def static_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pipe") / "static.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=6.0,
                      codec="libx264", motion_windows=())
    return path


@pytest.fixture(autouse=True)
def clear_timing():
    TimingCollector.clear()
    JaxTiming.clear()
    yield
    TimingCollector.clear()
    JaxTiming.clear()


def probe(path):
    with native.VideoReader(path) as r:
        return r.fps, r.width, r.height


class TestSingleFile:
    @pytest.mark.parametrize("scan_input", ["bits", "words"])
    def test_matches_jax_pipeline(self, motion_clip, tmp_path, scan_input):
        ours = ProcessingPipeline(
            motion_clip, str(tmp_path / "ours.mp4"),
            cfg=Config(scan_backend="torch", scan_input=scan_input))
        theirs = JaxPipeline(
            motion_clip, str(tmp_path / "theirs.mp4"),
            cfg=JaxConfig(scan_backend="xla", scan_input=scan_input))
        assert ours.run() == 0 and theirs.run() == 0
        assert (ours.time_removed, ours.saved_pct) == \
            (theirs.time_removed, theirs.saved_pct)
        assert 50.0 < ours.saved_pct < 80.0
        fps, w, h = probe(motion_clip)
        ts_ours = sorted(ours._parallel_scan("mv", fps, w, h).motion_ts)
        ts_theirs = sorted(theirs._parallel_scan("mv", fps, w, h).motion_ts)
        assert ts_ours == ts_theirs and len(ts_ours) > 50
        with native.VideoReader(str(tmp_path / "ours.mp4")) as a, \
                native.VideoReader(str(tmp_path / "theirs.mp4")) as b:
            assert a.duration == b.duration and 5.0 < a.duration < 10.0

    def test_static_clip_no_output(self, static_clip, tmp_path):
        out = str(tmp_path / "none.mp4")
        assert ProcessingPipeline(static_clip, out, cfg=TORCH).run() == 0
        assert not os.path.exists(out)

    def test_missing_input_fails(self, tmp_path):
        p = ProcessingPipeline("/nonexistent.mp4", str(tmp_path / "x.mp4"),
                               cfg=TORCH)
        assert p.run() == 1

    def test_mv_raw_static_clip_no_output(self, static_clip, tmp_path,
                                          capsys):
        """mv_raw is ported: a static clip scans clean and, with no
        motion, writes nothing."""
        out = str(tmp_path / "o.mp4")
        cfg = Config(scan_backend="torch", scan_input="mv_raw")
        assert ProcessingPipeline(static_clip, out, cfg=cfg).run() == 0
        assert "No motion found." in capsys.readouterr().out
        assert not os.path.exists(out)

    def test_grids_matches_jax_pipeline(self, motion_clip, tmp_path):
        """MVT_SCAN_INPUT=grids: uint8 vote grids through the cluster-map
        op give the JAX grids run's timestamps, savings and output."""
        ours = ProcessingPipeline(
            motion_clip, str(tmp_path / "ours.mp4"),
            cfg=Config(scan_backend="torch", scan_input="grids"))
        theirs = JaxPipeline(
            motion_clip, str(tmp_path / "theirs.mp4"),
            cfg=JaxConfig(scan_backend="xla", scan_input="grids"))
        assert ours.run() == 0 and theirs.run() == 0
        assert (ours.time_removed, ours.saved_pct) == \
            (theirs.time_removed, theirs.saved_pct)
        assert 50.0 < ours.saved_pct < 80.0
        fps, w, h = probe(motion_clip)
        ts_ours = sorted(ours._parallel_scan("mv", fps, w, h).motion_ts)
        ts_theirs = sorted(theirs._parallel_scan("mv", fps, w, h).motion_ts)
        assert ts_ours == ts_theirs and len(ts_ours) > 50
        with native.VideoReader(str(tmp_path / "ours.mp4")) as a, \
                native.VideoReader(str(tmp_path / "theirs.mp4")) as b:
            assert a.duration == b.duration and 5.0 < a.duration < 10.0

    def test_grids_heatmap_matches_jax(self, motion_clip, tmp_path):
        """The grids payload's heatmap counts cells at votes >=
        VECTORS_NEEDED, the same JSON document as the JAX grids run."""
        heat_ours, heat_theirs = tmp_path / "h1.json", tmp_path / "h2.json"
        ours = ProcessingPipeline(
            motion_clip, str(tmp_path / "a.mp4"),
            cfg=Config(scan_backend="torch", scan_input="grids",
                       heatmap_path=str(heat_ours)))
        theirs = JaxPipeline(
            motion_clip, str(tmp_path / "b.mp4"),
            cfg=JaxConfig(scan_backend="xla", scan_input="grids",
                          heatmap_path=str(heat_theirs)))
        assert ours.run() == 0 and theirs.run() == 0
        doc = json.loads(heat_ours.read_text())
        assert doc == json.loads(heat_theirs.read_text())
        assert doc["max_activity"] > 0

    def test_grids_at_vectors_needed_zero_runs_bits(self, static_clip,
                                                    tmp_path):
        cfg = Config(scan_backend="torch", scan_input="grids",
                     vectors_needed=0)
        out = str(tmp_path / "o.mp4")
        assert ProcessingPipeline(static_clip, out, cfg=cfg).run() == 0

    def test_auto_without_cuda_fails(self, static_clip, tmp_path,
                                     monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        p = ProcessingPipeline(static_clip, str(tmp_path / "o.mp4"),
                               cfg=Config())
        assert p.run() == 1
        assert "MVT_SCAN_BACKEND=torch" in capsys.readouterr().out

    def test_metrics_heatmap_and_profile(self, motion_clip, tmp_path):
        """MVT_METRICS_JSON, MVT_HEATMAP (the same JSON as the JAX
        pipeline's) and MVT_PROFILE_DIR (a torch.profiler trace)."""
        metrics = tmp_path / "m.jsonl"
        heat_ours, heat_theirs = tmp_path / "h1.json", tmp_path / "h2.json"
        prof = tmp_path / "prof"
        ours = ProcessingPipeline(
            motion_clip, str(tmp_path / "a.mp4"),
            cfg=Config(scan_backend="torch", metrics_json=str(metrics),
                       heatmap_path=str(heat_ours), profile_dir=str(prof)))
        assert ours.run() == 0
        theirs = JaxPipeline(
            motion_clip, str(tmp_path / "b.mp4"),
            cfg=JaxConfig(scan_backend="oracle",
                          heatmap_path=str(heat_theirs)))
        assert theirs.run() == 0
        assert json.loads(heat_ours.read_text())["activity"] == \
            json.loads(heat_theirs.read_text())["activity"]
        rec = json.loads(metrics.read_text().splitlines()[-1])
        assert rec["decision"] == "cut" and rec["frames_scanned"] > 400
        assert "  ├─warmup(build)" in rec["phases_us"]
        assert any(f.endswith(".json") for f in os.listdir(prof))


class TestBatch:
    def test_batch_two_files(self, motion_clip, static_clip, tmp_path):
        in_dir = tmp_path / "in"
        out_dir = tmp_path / "out"
        in_dir.mkdir()
        os.symlink(motion_clip, in_dir / "a_motion.mp4")
        os.symlink(static_clip, in_dir / "b_static.mp4")
        files = list_videos(str(in_dir))
        assert [os.path.basename(f) for f in files] == \
            ["a_motion.mp4", "b_static.mp4"]
        bp = BatchProcessor(2, TORCH)
        assert bp.process(files, str(out_dir), str(in_dir)) == 0
        assert os.path.exists(out_dir / "a_motion.mp4")
        assert not os.path.exists(out_dir / "b_static.mp4")  # no motion

    def test_failures_are_the_exit_code(self, static_clip, tmp_path):
        """Two inputs that do not open fail; the clean one does not."""
        in_dir = tmp_path / "in"
        in_dir.mkdir()
        (in_dir / "a.mp4").write_bytes(b"not a video")
        (in_dir / "b.mp4").write_bytes(b"")
        os.symlink(static_clip, in_dir / "c.mp4")
        bp = BatchProcessor(2, TORCH)
        assert bp.process(list_videos(str(in_dir)),
                          str(tmp_path / "out")) == 2

    def test_skip_existing_output(self, motion_clip, tmp_path):
        in_dir = tmp_path / "in"
        out_dir = tmp_path / "out"
        in_dir.mkdir()
        out_dir.mkdir()
        os.symlink(motion_clip, in_dir / "v.mp4")
        (out_dir / "v.mp4").write_bytes(b"sentinel")
        bp = BatchProcessor(1, TORCH)
        assert bp.process(list_videos(str(in_dir)), str(out_dir)) == 0
        assert (out_dir / "v.mp4").read_bytes() == b"sentinel"

    def test_watch_mode_picks_up_a_new_file(self, static_clip, motion_clip,
                                            tmp_path):
        in_dir = tmp_path / "in"
        out_dir = tmp_path / "out"
        in_dir.mkdir()
        out_dir.mkdir()
        bp = BatchProcessor(1, Config(scan_backend="torch", watch_mode=True))
        result = {}
        t = threading.Thread(target=lambda: result.update(
            rc=bp.process([], str(out_dir), str(in_dir))), daemon=True)
        t.start()
        try:
            staging = tmp_path / "new.mp4"
            shutil.copy(motion_clip, staging)
            os.rename(staging, in_dir / "new.mp4")
            deadline = time.time() + 90
            while time.time() < deadline and \
                    not (out_dir / "new.mp4").exists():
                time.sleep(0.25)
            assert (out_dir / "new.mp4").exists()
        finally:
            bp.stop()
            t.join(timeout=60)
        assert not t.is_alive()
        assert result["rc"] == 0


class TestCLI:
    def test_usage_error(self):
        assert cli_main([]) == 1
        assert cli_main(["only_one"]) == 1

    def test_single_file(self, motion_clip, tmp_path, monkeypatch):
        monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
        out = str(tmp_path / "cli.mp4")
        assert cli_main([motion_clip, out]) == 0
        assert os.path.exists(out)

    @pytest.mark.parametrize("pipeline", ["mv", "sad", "auto"])
    def test_archive_mode_matches_jax_cli(self, motion_clip, tmp_path,
                                          monkeypatch, capsys, pipeline):
        """MVT_ARCHIVE=1 through both CLIs, payload bits (mv, auto) and
        sad: the same segments, so the same output bytes."""
        monkeypatch.setenv("MVT_ARCHIVE", "1")
        monkeypatch.setenv("MVT_PIPELINE", pipeline)
        monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
        ours = str(tmp_path / "ours.mp4")
        assert cli_main([motion_clip, ours]) == 0
        monkeypatch.delenv("MVT_SCAN_BACKEND")
        theirs = str(tmp_path / "theirs.mp4")
        assert jax_cli_main([motion_clip, theirs]) == 0
        out = capsys.readouterr().out
        payload = "sad" if pipeline == "sad" else "bits"
        assert out.count(f"archive scan ({payload})") == 2
        data = open(ours, "rb").read()
        assert len(data) > 1000 and data == open(theirs, "rb").read()

    def test_empty_dir(self, tmp_path):
        d = tmp_path / "empty"
        d.mkdir()
        assert cli_main([str(d), str(tmp_path / "o")]) == 0


def test_port_runs_without_jax(static_clip, tmp_path):
    """A fresh interpreter runs the port's CLI and never imports jax."""
    code = (
        "import sys\n"
        "from mvtrim_tpu_torch.cli import main\n"
        f"rc = main([{static_clip!r}, {str(tmp_path / 'o.mp4')!r}])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('JAX_FREE')\n")
    env = dict(os.environ, MVT_SCAN_BACKEND="torch",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "JAX_FREE" in proc.stdout
