"""MVT_SCAN_INPUT=mv_raw in mvtrim_tpu_torch vs the JAX package.

``python -m mvtrim_tpu_torch`` on the raw-MV payload (plain PyTorch build,
``MVT_SCAN_BACKEND=torch``) must give the JAX mv_raw run's motion
timestamps, savings and output bytes, and the port's own bits run's; also
at ``MVT_MV_CAPACITY=16``, where every chunk overflows its capacity, is
restarted at the next power of two and is decided by the raw-MV op at
that capacity.  Integer decisions: the tolerance is exact.
"""

import pytest

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline as JaxPipeline
from mvtrim_tpu_torch.cli import main as cli_main
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.ops import mv_vote as torch_mv
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline


@pytest.fixture(scope="module")
def motion_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("raw") / "motion.mp4")
    native.synthesize(path, width=640, height=480, fps=25.0, duration=20.0,
                      codec="libx264",
                      motion_windows=((2.0, 5.0), (12.0, 14.0)))
    return path


def probe(clip):
    with native.VideoReader(clip) as r:
        return r.duration, r.fps, r.width, r.height


def motion_ts(pipe, clip):
    pipe.duration, fps, w, h = probe(clip)
    return sorted(pipe._parallel_scan("mv", fps, w, h).motion_ts)


@pytest.mark.parametrize("capacity", [8192, 16])
def test_cli_matches_jax_and_the_bits_run(motion_clip, tmp_path,
                                          monkeypatch, capacity):
    env = dict(MVT_SCAN_BACKEND="torch", MVT_SCAN_INPUT="mv_raw",
               MVT_MV_CAPACITY=str(capacity), MVT_DEVICE_BATCH="256")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = str(tmp_path / "ours.mp4")
    assert cli_main([motion_clip, ours]) == 0
    cfg = Config.from_env()
    assert (cfg.scan_input, cfg.mv_capacity) == ("mv_raw", capacity)
    port = ProcessingPipeline(motion_clip, str(tmp_path / "p.mp4"), cfg=cfg)
    theirs = JaxPipeline(motion_clip, str(tmp_path / "theirs.mp4"),
                         cfg=JaxConfig(scan_backend="xla",
                                       scan_input="mv_raw",
                                       mv_capacity=capacity,
                                       device_batch=256))
    bits = ProcessingPipeline(motion_clip, str(tmp_path / "bits.mp4"),
                              cfg=Config(scan_backend="torch"))
    assert port.run() == 0 and theirs.run() == 0 and bits.run() == 0
    assert (port.time_removed, port.saved_pct) == \
        (theirs.time_removed, theirs.saved_pct) == \
        (bits.time_removed, bits.saved_pct)
    assert 50.0 < port.saved_pct < 80.0
    ts = motion_ts(port, motion_clip)
    assert ts == motion_ts(theirs, motion_clip) == motion_ts(bits,
                                                              motion_clip)
    assert len(ts) > 50
    data = open(ours, "rb").read()
    assert data == open(str(tmp_path / "theirs.mp4"), "rb").read() == \
        open(str(tmp_path / "bits.mp4"), "rb").read()


def test_overflow_restarts_the_chunk_on_the_host(motion_clip, tmp_path,
                                                 monkeypatch):
    """At capacity 16 the worker restarts each chunk from a fresh seek at
    a fitting capacity, and the feeder hands the re-decoded chunk to
    ``mv_cluster_op`` at that capacity (never to the host oracle): the
    same decisions as the oracle backend, every frame counted once."""
    shapes = []
    real_op = torch_mv.mv_cluster_op

    def spy(mvs, counts, *args, **kw):
        shapes.append(tuple(mvs.shape))
        assert (counts >= 0).all()
        return real_op(mvs, counts, *args, **kw)

    def no_host(self, mvs, counts):
        raise AssertionError("an overflow chunk was decided on the host")

    monkeypatch.setattr(torch_mv, "mv_cluster_op", spy)
    monkeypatch.setattr(MVClusterDetector, "decide_raw_mvs_on_host",
                        no_host)
    cfg = Config(scan_backend="torch", scan_input="mv_raw", mv_capacity=16,
                 chunk_duration_sec=7.0)
    pipe = ProcessingPipeline(motion_clip, str(tmp_path / "o.mp4"), cfg=cfg)
    pipe.duration, fps, w, h = probe(motion_clip)
    result = pipe._parallel_scan("mv", fps, w, h)
    monkeypatch.undo()
    ref = ProcessingPipeline(motion_clip, str(tmp_path / "r.mp4"),
                             cfg=Config(scan_backend="oracle",
                                        scan_input="mv_raw",
                                        chunk_duration_sec=7.0))
    ref.duration = pipe.duration
    expect = ref._parallel_scan("mv", fps, w, h)
    assert sorted(result.motion_ts) == sorted(expect.motion_ts)
    assert result.frames_scanned == expect.frames_scanned
    assert result.frames_with_mvs == expect.frames_with_mvs
    # the warm-up's one frame at M = 16, then every frame of the clip at
    # the capacity its chunk was re-decoded at
    assert shapes[0] == (1, 16, 4)
    assert sum(s[0] for s in shapes[1:]) == result.frames_scanned
    assert all(s[1] > 16 for s in shapes[1:])


def test_warm_up_covers_both_buckets(motion_clip, tmp_path, monkeypatch):
    """The warm-up is one frame: dispatches are not padded to buckets, so
    there is no second shape to warm."""
    seen = []
    real = MVClusterDetector.scan_raw_mvs

    def spy(self, mvs, counts):
        seen.append(len(counts))
        return real(self, mvs, counts)

    monkeypatch.setattr(MVClusterDetector, "scan_raw_mvs", spy)
    cfg = Config(scan_backend="torch", scan_input="mv_raw",
                 device_batch=1024)
    pipe = ProcessingPipeline(motion_clip, str(tmp_path / "o.mp4"), cfg=cfg)
    assert pipe.run() == 0
    assert seen == [1]


def test_heatmap_is_skipped_with_a_warning(motion_clip, tmp_path, capsys):
    heat = tmp_path / "h.json"
    cfg = Config(scan_backend="torch", scan_input="mv_raw",
                 heatmap_path=str(heat))
    assert ProcessingPipeline(motion_clip, str(tmp_path / "o.mp4"),
                              cfg=cfg).run() == 0
    assert "MVT_HEATMAP is unavailable" in capsys.readouterr().out
    assert not heat.exists()


def test_oracle_backend_matches(motion_clip, tmp_path):
    a = ProcessingPipeline(motion_clip, str(tmp_path / "a.mp4"),
                           cfg=Config(scan_backend="oracle",
                                      scan_input="mv_raw"))
    b = ProcessingPipeline(motion_clip, str(tmp_path / "b.mp4"),
                           cfg=Config(scan_backend="torch",
                                      scan_input="mv_raw"))
    assert a.run() == 0 and b.run() == 0
    assert motion_ts(a, motion_clip) == motion_ts(b, motion_clip)
    assert a.saved_pct == b.saved_pct
    assert open(tmp_path / "a.mp4", "rb").read() == \
        open(tmp_path / "b.mp4", "rb").read()
