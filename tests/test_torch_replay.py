"""Recorded encoder payloads (mvtrim_tpu_torch/bench/replay.py).

Three properties.  A recording is faithful: every payload the replay
serves equals the live native scan of the same clip byte for byte, over
chunk ranges, cap-resumed parts and overflowing MV capacities.  Both
packages decide every committed fixture as the oracle backend decided the
real decode: the JAX package's ProcessingPipeline (its ``native.
VideoReader`` replaced in the test) and the port's CPU build give each
fixture's stored concat list.  And a scan whose knobs differ from the
recorded ones raises.
"""

import os

import numpy as np
import pytest

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.io import native as jax_native
from mvtrim_tpu.pipeline.pipeline import ProcessingPipeline as JaxPipeline
from mvtrim_tpu.utils.timing import TimingCollector as JaxTiming
from mvtrim_tpu_torch.bench import replay
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.utils.timing import TimingCollector


@pytest.fixture(autouse=True)
def clear_timing():
    yield
    TimingCollector.clear()
    JaxTiming.clear()


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A small noisy B-frame clip and its recording: (clip, Fixture)."""
    d = tmp_path_factory.mktemp("replay")
    clip = str(d / "cam.mp4")
    native.synthesize(clip, width=320, height=240, fps=25.0, duration=8.0,
                      codec="libx264", b_frames=2, noise=3,
                      motion_windows=((2.0, 4.0),))
    out = str(d / "cam.npz")
    replay.record(clip, out, Config())
    return clip, replay.load(out)


@pytest.fixture(scope="module")
def recorded_intra(tmp_path_factory):
    """An all-intra clip (no MV side data) and its recording."""
    d = tmp_path_factory.mktemp("replay_intra")
    clip = str(d / "intra.mp4")
    native.synthesize(clip, width=192, height=128, fps=25.0, duration=4.0,
                      codec="libx264", gop=1,
                      motion_windows=((1.0, 2.0),))
    out = str(d / "intra.npz")
    replay.record(clip, out, Config(), payloads=("bits",))
    return clip, replay.load(out)


def _scan_args(fx):
    k = fx.meta["knobs"]
    return dict(threshold_sq=k["threshold_sq"], block_shift=k["block_shift"],
                gw=k["gw"], gh=k["gh"], y_min=k["y_min"], y_max=k["y_max"])


def _call(reader, scan, fx, start, end, max_frames, resume, timing):
    args = dict(max_frames=max_frames, resume=resume, timing=timing)
    if scan in ("bits", "words"):
        args.update(_scan_args(fx),
                    vectors_needed=fx.meta["knobs"]["vectors_needed"])
    elif scan == "grids":
        args.update(_scan_args(fx))
    elif scan == "grids_multi":
        args.update(_scan_args(fx))
        args["thresholds_sq"] = [args.pop("threshold_sq")]
    elif scan.startswith("mvs"):
        args["max_mv"] = int(scan.split("@")[1])
        scan = "mvs"
    if scan == "luma":
        args.pop("timing")
    return getattr(reader, f"scan_{scan}")(start, end, **args)


# (start, end, frames a call) of each scan: whole clip, the chunks of a
# 3 s chunking, a cap-resumed chunk, a resume past a range that ended
RANGES = [[(0.0, 99.0, 4096)],
          [(0.0, 3.0, 4096), (3.0, 6.0, 4096), (6.0, 99.0, 4096)],
          [(2.5, 7.5, 7)] * 6,
          [(0.0, 3.0, 4096), (0.0, 6.0, 4096)]]


def _compare(clip, fx, scan, ranges, mode=native.MVT_MODE_MV):
    """The same calls on one live handle and one replay reader (the
    second and later calls of RANGES[2] and RANGES[3] resume)."""
    live = native.VideoReader(clip, mode)
    rep = replay.ReplayReader(fx, mode, clip)
    tl, tr = native.ScanTiming(), native.ScanTiming()
    served = 0
    try:
        for i, (start, end, cap) in enumerate(ranges):
            resume = i > 0 and (ranges is RANGES[2] or ranges is RANGES[3])
            want = _call(live, scan, fx, start, end, cap, resume, tl)
            got = _call(rep, scan, fx, start, end, cap, resume, tr)
            assert len(want) == len(got)
            for w, g in zip(want, got):
                assert w.dtype == g.dtype and w.shape == g.shape, (scan, i)
                assert w.tobytes() == g.tobytes(), (scan, i)
            served += len(want[1])
    finally:
        live.close()
    assert tl.frames_with_mvs == tr.frames_with_mvs
    return served


class TestRecordingIsFaithful:
    @pytest.mark.parametrize("ranges", range(len(RANGES)))
    @pytest.mark.parametrize("scan", ["bits", "words", "grids",
                                      "grids_multi", "mvs@65536"])
    def test_served_equals_live_scan(self, recorded, scan, ranges):
        clip, fx = recorded
        assert _compare(clip, fx, scan, RANGES[ranges]) > 0

    def test_overflowed_mv_frames(self, recorded):
        """At a capacity below the fuller frames' counts each such frame
        comes back truncated with its count negated, as live."""
        clip, fx = recorded
        counts = fx.arrays["mv_counts"]
        cap = int(np.median(counts[counts > 0]))
        assert (counts > cap).any()
        assert _compare(clip, fx, f"mvs@{cap}", RANGES[2]) > 0
        _, c, _ = replay.ReplayReader(fx).scan_mvs(0.0, 99.0, max_mv=cap)
        assert (c < 0).sum() == (counts > cap).sum()

    @pytest.mark.parametrize("ranges", [1, 2])
    def test_luma_of_a_clip_without_mvs(self, recorded_intra, ranges):
        clip, fx = recorded_intra
        assert "luma" in fx.meta["payloads"]
        assert not fx.has_mv.any()
        assert _compare(clip, fx, "luma", RANGES[ranges],
                        native.MVT_MODE_LUMA) > 0
        assert _compare(clip, fx, "bits", RANGES[ranges]) > 0

    def test_probe_and_list(self, recorded):
        clip, fx = recorded
        with native.VideoReader(clip) as r:
            assert (r.width, r.height, r.fps, r.duration) == (
                fx.meta["width"], fx.meta["height"], fx.meta["fps"],
                fx.meta["duration"])
        assert fx.concat(clip).startswith(f"file '{clip}'")


def _replay_run(fx, run, fields, tmp_path, monkeypatch, package):
    src = str(tmp_path / f"{fx.name}_{run}.mp4")
    dump = str(tmp_path / f"{fx.name}_{run}.concat")
    monkeypatch.setenv("MVT_CONCAT_DUMP", dump)
    if package == "jax":
        monkeypatch.setattr(jax_native, "VideoReader", replay.opener(fx))
        cfg = JaxConfig(**fx.meta["config"], **fields, scan_backend="xla",
                        ffmpeg_bin=replay.FAKE_FFMPEG)
        rc = JaxPipeline(src, src + ".out", cfg=cfg).run()
    else:
        monkeypatch.setattr(native, "VideoReader", replay.opener(fx))
        cfg = fx.config(**fields, scan_backend="torch",
                        ffmpeg_bin=replay.FAKE_FFMPEG)
        rc = ProcessingPipeline(src, src + ".out", cfg=cfg).run()
    assert rc == 0
    with open(dump) as f:
        return f.read(), fx.concat(src)


FIXTURE_RUNS = [(name, run, fields)
                for name, spec in replay.FIXTURES.items()
                for run, fields in spec.runs]


class TestBothPackagesAgreeOverReplay:
    @pytest.mark.parametrize("package", ["jax", "torch"])
    @pytest.mark.parametrize("name,run,fields", FIXTURE_RUNS,
                             ids=[f"{n}-{r}" for n, r, _ in FIXTURE_RUNS])
    def test_stored_list(self, name, run, fields, package, tmp_path,
                         monkeypatch):
        fx = replay.load(name)
        got, want = _replay_run(fx, run, fields, tmp_path, monkeypatch,
                                package)
        assert want.count("inpoint") >= 1
        assert got == want

    def test_fixtures_stay_small(self):
        sizes = {n: os.path.getsize(replay.path(n)) for n in replay.FIXTURES}
        assert sum(sizes.values()) <= 8 * 2 ** 20, sizes

    def test_fixture_b_overflows_the_default_capacity(self, tmp_path,
                                                      monkeypatch):
        """Most of B's frames overflow the default capacity, and the
        pipeline re-decodes its chunk at 32768 before deciding it."""
        fx = replay.load("B")
        counts = fx.arrays["mv_counts"]
        assert (counts > Config().mv_capacity).sum() >= len(counts) // 2
        assert counts.max() > 16384
        caps = []

        class Traced(replay.ReplayReader):
            def scan_mvs(self, *args, **kw):
                caps.append(kw["max_mv"])
                return super().scan_mvs(*args, **kw)

        monkeypatch.setattr(native, "VideoReader",
                            lambda path, mode=0: Traced(fx, mode, path))
        src = str(tmp_path / "b.mp4")
        assert ProcessingPipeline(src, src + ".out", cfg=fx.config(
            scan_backend="torch", scan_input="mv_raw",
            ffmpeg_bin=replay.FAKE_FFMPEG)).run() == 0
        assert sorted(set(caps)) == [8192, 32768]


class TestKnobMismatchRaises:
    @pytest.mark.parametrize("change", [
        dict(threshold_sq=17.0), dict(vectors_needed=3),
        dict(block_shift=3), dict(gw=119), dict(y_min=0),
        dict(frame_skip=2)])
    def test_scan_raises(self, change):
        fx = replay.load("C")
        args = dict(_scan_args(fx), vectors_needed=2, frame_skip=1)
        args.update(change)
        with pytest.raises(ValueError, match="recorded at"):
            replay.ReplayReader(fx).scan_bits(0.0, 99.0, **args)

    def test_unrecorded_payload_and_mode_raise(self):
        fx = replay.load("C")
        with pytest.raises(ValueError, match="not recorded"):
            replay.ReplayReader(fx).scan_mvs(0.0, 99.0)
        with pytest.raises(ValueError, match="mode"):
            replay.ReplayReader(fx, native.MVT_MODE_LUMA).scan_bits(
                0.0, 99.0, **_scan_args(fx), vectors_needed=2)

    def test_pipeline_at_another_threshold_fails(self, tmp_path,
                                                 monkeypatch):
        """The pipeline under another MV_THRESHOLD_SQ than the recording's
        fails its scan (rc 1), never deciding another threshold's
        payload."""
        fx = replay.load("C")
        monkeypatch.setattr(native, "VideoReader", replay.opener(fx))
        cfg = fx.config(scan_backend="torch", mv_threshold_sq=20.0,
                        ffmpeg_bin=replay.FAKE_FFMPEG)
        src = str(tmp_path / "c.mp4")
        assert ProcessingPipeline(src, src + ".out", cfg=cfg).run() == 1
