"""Twin of tests/test_robustness.py on the port's CPU build.

Concurrency stress, corrupt inputs and failure accounting: every case of
the JAX suite on the same inputs, through the port's ProcessingPipeline
and BatchProcessor (``scan_backend="torch"``), against the JAX package's
(its suite's ``oracle`` backend).  Return codes, the seconds removed, the
saved share and which outputs exist must be the JAX package's, exactly.
"""

import os

import pytest

from mvtrim_tpu.batch.batch import BatchProcessor as JaxBatch
from mvtrim_tpu.batch.batch import list_videos as jax_list_videos
from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline as JaxPipeline
from mvtrim_tpu.utils.timing import TimingCollector as JaxTiming
from mvtrim_tpu_torch.batch.batch import BatchProcessor, list_videos
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.utils.timing import TimingCollector


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rob") / "m.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=24.0,
                      codec="libx264",
                      motion_windows=((2.0, 4.0), (10.0, 12.0), (18.0, 20.0)))
    return path


@pytest.fixture(autouse=True)
def clear_timing():
    yield
    TimingCollector.clear()
    JaxTiming.clear()


_jax: dict = {}


def jax_run(path, out, **cfg):
    """The JAX package's pipeline under its suite's oracle backend, once
    per input and config: (rc, seconds removed, saved %)."""
    key = (path, tuple(sorted(cfg.items())))
    if key not in _jax:
        p = JaxPipeline(path, out, cfg=JaxConfig(scan_backend="oracle",
                                                 **cfg))
        _jax[key] = (p.run(), p.time_removed, p.saved_pct)
    return _jax[key]


def run(path, out, **cfg):
    p = ProcessingPipeline(path, out, cfg=Config(scan_backend="torch",
                                                 **cfg))
    return p.run(), p.time_removed, p.saved_pct


class TestConcurrencyStress:
    def test_many_workers_deterministic(self, clip, tmp_path):
        """8 decode workers over 3 s chunks decide as one worker does,
        and as the JAX package does."""
        results = []
        for workers in (1, 8):
            got = run(clip, str(tmp_path / f"w{workers}.mp4"),
                      chunk_duration_sec=3.0, decode_workers=workers)
            assert got[0] == 0
            results.append(got)
        assert results[0] == results[1]
        assert results[0] == jax_run(clip, str(tmp_path / "j.mp4"),
                                     chunk_duration_sec=3.0,
                                     decode_workers=1)

    def test_repeated_runs_identical(self, clip, tmp_path):
        vals = {run(clip, str(tmp_path / f"r{i}.mp4"),
                    chunk_duration_sec=5.0, decode_workers=4)
                for i in range(3)}
        assert len(vals) == 1
        assert vals == {jax_run(clip, str(tmp_path / "j.mp4"),
                                chunk_duration_sec=5.0, decode_workers=4)}


class TestCorruptInputs:
    def test_garbage_file(self, tmp_path):
        bad = tmp_path / "garbage.mp4"
        bad.write_bytes(os.urandom(4096))
        assert run(str(bad), str(tmp_path / "o.mp4"))[0] == 1
        assert not (tmp_path / "o.mp4").exists()
        assert jax_run(str(bad), str(tmp_path / "j.mp4"))[0] == 1
        assert not (tmp_path / "j.mp4").exists()

    def test_truncated_file(self, clip, tmp_path):
        data = open(clip, "rb").read()
        trunc = tmp_path / "trunc.mp4"
        trunc.write_bytes(data[:len(data) // 3])
        got = run(str(trunc), str(tmp_path / "t.mp4"))
        assert got[0] in (0, 1)
        assert got == jax_run(str(trunc), str(tmp_path / "j.mp4"))

    def test_empty_file(self, tmp_path):
        empty = tmp_path / "empty.mp4"
        empty.write_bytes(b"")
        assert run(str(empty), str(tmp_path / "e.mp4"))[0] == 1
        assert jax_run(str(empty), str(tmp_path / "j.mp4"))[0] == 1

    def test_batch_continues_past_failures(self, clip, tmp_path):
        """A bad file fails; the rest of the batch still processes, in
        both packages."""
        in_dir = tmp_path / "in"
        in_dir.mkdir()
        os.symlink(clip, in_dir / "a_good.mp4")
        (in_dir / "b_bad.mp4").write_bytes(os.urandom(2048))
        os.symlink(clip, in_dir / "c_good2.mp4")
        outs = {}
        for name, batch, lister, cfg in (
                ("torch", BatchProcessor, list_videos,
                 Config(scan_backend="torch")),
                ("jax", JaxBatch, jax_list_videos,
                 JaxConfig(scan_backend="oracle"))):
            out_dir = tmp_path / f"out_{name}"
            failures = batch(2, cfg).process(lister(str(in_dir)),
                                             str(out_dir))
            outs[name] = (failures, sorted(os.listdir(out_dir)))
        assert outs["torch"] == (1, ["a_good.mp4", "c_good2.mp4"])
        assert outs["torch"] == outs["jax"]
