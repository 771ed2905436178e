"""The port's watch daemon (mvtrim_tpu_torch/batch/batch.py), on the CPU.

The counterparts of tests/test_watch.py's six cases, on the port's
``BatchProcessor`` and ``python -m mvtrim_tpu_torch``: full concurrency in
watch mode, a new file detected and processed, an existing output not
reprocessed, the MVT_RSS_LIMIT_MB watchdog, abort against stop, and SIGINT
ending a daemon process.  Then the soak
(``python -m mvtrim_tpu_torch.bench.soak_watch``) on its synthesized
clips at the CPU build: healthy over four files, its growth rule, and its
refusal to report a soak it could not run.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import pytest

from mvtrim_tpu_torch.batch.batch import BatchProcessor
from mvtrim_tpu_torch.bench import soak_watch
from mvtrim_tpu_torch.core.config import Config
from mvtrim_tpu_torch.io import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_for(predicate, timeout=90.0, interval=0.25):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(scope="module")
def small_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("watch") / "seed.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=6.0,
                      codec="libx264", motion_windows=((1.0, 3.0),))
    return path


class TestWatchMode:
    def test_watch_keeps_full_concurrency(self):
        bp = BatchProcessor(num_streams=4)
        want = bp.num_streams  # may be CPU-clamped below 4
        assert bp._plan_streams(0, watch=True) == want
        assert bp._plan_streams(1, watch=True) == want
        assert bp._plan_streams(1, watch=False) == 1
        assert bp._plan_streams(0, watch=False) == want

    def test_new_file_detected_and_processed(self, small_clip, tmp_path):
        in_dir = tmp_path / "in"
        out_dir = tmp_path / "out"
        in_dir.mkdir()
        out_dir.mkdir()
        shutil.copy(small_clip, in_dir / "first.mp4")
        cfg = Config(watch_mode=True, scan_backend="oracle",
                     parallel_streams=1)
        bp = BatchProcessor(1, cfg)
        result = {}

        def run():
            result["failures"] = bp.process(
                [str(in_dir / "first.mp4")], str(out_dir), str(in_dir))

        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            assert wait_for(lambda: (out_dir / "first.mp4").exists()), \
                "initial file not processed"
            # dropped in atomically: the 500 ms stability check accepts it
            staging = tmp_path / "second.mp4"
            shutil.copy(small_clip, staging)
            os.rename(staging, in_dir / "second.mp4")
            assert wait_for(lambda: (out_dir / "second.mp4").exists()), \
                "watched file not processed"
        finally:
            bp.stop()
        t.join(timeout=60)
        assert not t.is_alive(), "watch mode did not terminate after stop()"
        assert result.get("failures") == 0

    def test_existing_output_not_reprocessed(self, small_clip, tmp_path):
        in_dir = tmp_path / "in2"
        out_dir = tmp_path / "out2"
        in_dir.mkdir()
        out_dir.mkdir()
        shutil.copy(small_clip, in_dir / "v.mp4")
        sentinel = out_dir / "v.mp4"
        sentinel.write_bytes(b"sentinel")
        bp = BatchProcessor(1, Config(watch_mode=True, scan_backend="oracle"))
        t = threading.Thread(
            target=lambda: bp.process([], str(out_dir), str(in_dir)),
            daemon=True)
        t.start()
        try:
            time.sleep(4.0)  # a couple of poll cycles
            assert sentinel.read_bytes() == b"sentinel"
        finally:
            bp.stop()
        t.join(timeout=30)
        assert not t.is_alive()

    def test_rss_watchdog_stops_daemon(self, tmp_path):
        """MVT_RSS_LIMIT_MB below the process's RSS: the monitor stops the
        daemon on its own, for the supervisor to restart it."""
        in_dir = tmp_path / "in3"
        out_dir = tmp_path / "out3"
        in_dir.mkdir()
        out_dir.mkdir()
        cfg = Config(watch_mode=True, scan_backend="oracle",
                     rss_limit_mb=1.0)  # any real process exceeds 1MB
        bp = BatchProcessor(1, cfg)
        result = {}
        t = threading.Thread(
            target=lambda: result.update(
                rc=bp.process([], str(out_dir), str(in_dir))),
            daemon=True)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "watchdog did not stop the daemon"
        assert result["rc"] == 0

    def test_abort_drops_backlog_stop_drains_it(self):
        cfg = Config(watch_mode=False, scan_backend="oracle")
        bp = BatchProcessor(1, cfg)
        bp._work.put("a.mp4")
        bp._work.put("b.mp4")
        assert bp._get_next_file() == "a.mp4"
        bp.abort()
        assert bp._get_next_file() is None, "abort must drop the backlog"

        bp2 = BatchProcessor(1, cfg)
        bp2._work.put("a.mp4")
        bp2.stop()
        assert bp2._get_next_file() == "a.mp4", \
            "stop() must still drain queued work"

        bp3 = BatchProcessor(1, Config(watch_mode=True,
                                       scan_backend="oracle"))
        bp3._work.put("a.mp4")
        bp3.abort()
        assert bp3._get_next_file() is None, \
            "watch-mode branch must honor abort too"

    def test_sigint_terminates_watch_daemon(self, small_clip, tmp_path):
        """SIGINT to a running ``python -m mvtrim_tpu_torch`` watch daemon
        ends the process cleanly, exit code 0: its monitor and stream
        workers are not daemon threads and must be stopped."""
        in_dir = tmp_path / "sig_in"
        out_dir = tmp_path / "sig_out"
        in_dir.mkdir()
        out_dir.mkdir()
        shutil.copy(small_clip, in_dir / "v.mp4")
        env = dict(os.environ, WATCH_MODE="1", MVT_SCAN_BACKEND="oracle",
                   PARALLEL_STREAMS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        p = subprocess.Popen(
            [sys.executable, "-m", "mvtrim_tpu_torch", str(in_dir),
             str(out_dir)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)
        try:
            assert wait_for(lambda: (out_dir / "v.mp4").exists(),
                            timeout=120), "initial file never processed"
            p.send_signal(signal.SIGINT)
            out, _ = p.communicate(timeout=90)
        except Exception:
            p.kill()
            p.wait()
            raise
        tail = out.decode(errors="replace")[-2000:]
        assert p.returncode == 0, tail
        assert "BATCH PROCESSING SUMMARY" in tail, tail


class TestSoak:
    def test_four_files_at_the_cpu_build_are_healthy(self, monkeypatch,
                                                     capsys):
        """Four 10 s 640x480 clips through a daemon of the CPU build."""
        monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
        rc = soak_watch.main(["--files", "4", "--timeout-per-file", "60"])
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0, result
        assert result["healthy"] and result["files_processed"] == 4
        assert len(result["rss_samples_mb"]) == 4
        assert all(r > 0 for r in result["rss_samples_mb"])
        # no card here: nvidia-smi lists no device memory for the daemon
        assert result["device_samples_mb"] == [None] * 4
        assert all(0 < t < 60 for t in result["latency_s"])

    @pytest.mark.parametrize("series,healthy", [
        ({"rss_mb": [300, 420, 430, 440, 479.9]}, True),    # warm-up, 49.9
        ({"rss_mb": [300, 301, 302, 330, 352]}, False),     # 50 MB growth
        ({"rss_mb": [300, 300, 300, 300],
          "device_mb": [500, 900, 900, 950]}, False),       # device grows
        ({"rss_mb": [300, 300, 300, 300],
          "device_mb": [None, None, None, None]}, True),    # no card
    ])
    def test_growth_rule(self, series, healthy):
        """The JAX soak's rule: growth from the third sample to the last
        below 50 MB, in every series."""
        assert soak_watch.memory_healthy(series) is healthy

    def test_without_libav_it_fails_and_reports_nothing(self, monkeypatch,
                                                        capsys):
        def no_lib():
            raise OSError("libavformat.so.61: cannot open shared object")

        monkeypatch.setattr(native, "_load_library", no_lib)
        assert soak_watch.main(["--files", "2"]) == 2
        out = capsys.readouterr()
        assert out.out == ""
        assert "does not load" in out.err and "nothing was soaked" in out.err
