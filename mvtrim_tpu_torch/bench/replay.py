"""Recorded encoder payloads, replayed in place of the decoder.

A machine without FFmpeg's libav* cannot decode a clip, so it cannot see
what a real encoder's motion vectors look like.  ``record`` runs the
native scans (``io/native.py``) over a real clip once and stores what each
scan returns, as it returns it: the activity masks (``scan_bits``,
``scan_words``), the vote grids (``scan_grids_multi`` at the recorded
threshold, with the per-frame side-data flags), every live MV of every
frame (``scan_mvs`` at a capacity that holds the fullest frame, stored
ragged), and, where no frame carries MVs, the luma (``scan_luma``); with
the clip's probe and the concat list that the oracle backend cuts the real
decode to.  ``ReplayReader`` then stands in for ``native.VideoReader``
over one such fixture, so the pipeline runs its chunks, cap resumes and
overflow re-decodes on the recorded payloads.

The committed fixtures (``replay_data/``) and the ``native.synthesize``
arguments of each are ``FIXTURES``; this rebuilds them where libav loads:

    python -m mvtrim_tpu_torch.bench.replay --record [--only A,B]

A scan whose knobs differ from the recorded ones (threshold, block shift,
vote threshold, grid, frame skip, open mode) raises: a fixture never
serves a payload made for another configuration.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..core.config import Config
from ..core.types import GridGeometry
from ..io import native

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "replay_data")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FAKE_FFMPEG = os.path.join(_ROOT, "parity", "fake_ffmpeg.sh")
# the input path as the stored concat list names it
INPUT_TOKEN = "@INPUT@"
MV_PAYLOADS = ("bits", "words", "grids", "mvs")
# frames a recording scan call takes (the MV rows a call holds are this
# times the capacity)
RECORD_PART = 64


@dataclasses.dataclass(frozen=True)
class Spec:
    """A fixture: the clip (``native.synthesize``'s arguments), the scans
    recorded, the Config fields the recording and every replay share, and
    the runs that replay it: (name, Config fields of that run)."""

    synth: dict
    payloads: tuple
    config: dict
    runs: tuple


FIXTURES = {
    # the main path at full width: a noisy 1080p camera with B-frames
    "A": Spec(dict(width=1920, height=1080, fps=25.0, duration=60.0,
                   codec="libx264", b_frames=2, noise=4,
                   motion_windows=((6.0, 14.0), (27.0, 31.0),
                                   (45.0, 52.0))),
              ("bits", "words", "grids"), {"mv_threshold_sq": 64.0},
              (("bits", {}), ("words", {"scan_input": "words"}),
               ("grids", {"scan_input": "grids"}))),
    # raw MVs of a noisy 1080p camera: most frames overflow the default
    # capacity of 8192 rows
    "B": Spec(dict(width=1920, height=1080, fps=25.0, duration=10.0,
                   codec="libx264", b_frames=2, noise=4,
                   motion_windows=((3.0, 6.0),)),
              ("mvs",), {"mv_threshold_sq": 64.0},
              (("mv_raw", {"scan_input": "mv_raw"}),)),
    # the 240 x 135 grid of 4K
    "C": Spec(dict(width=3840, height=2160, fps=25.0, duration=4.0,
                   codec="libx264", motion_windows=((1.0, 2.5),)),
              ("bits",), {}, (("bits", {}),)),
    # HEVC: no MV side data from this decoder, so auto takes the SAD path
    # over the luma; noise-free and small, since luma compresses poorly
    "D": Spec(dict(width=640, height=360, fps=25.0, duration=10.0,
                   codec="libx265", motion_windows=((2.0, 4.0),
                                                    (6.5, 8.0))),
              ("bits",), {}, (("auto", {"pipeline_mode": "auto"}),)),
}


def path(name: str) -> str:
    return os.path.join(DATA_DIR, f"{name}.npz")


def scan_knobs(cfg: Config, width: int, height: int) -> dict:
    """The knobs a recorded MV payload depends on."""
    geom = GridGeometry.build(width, height, cfg)
    return dict(threshold_sq=float(cfg.mv_threshold_sq),
                block_shift=int(cfg.block_shift),
                vectors_needed=int(cfg.vectors_needed), gw=geom.gw,
                gh=geom.gh, y_min=geom.y_min, y_max=geom.y_max, frame_skip=1)


def _scan_all(scan, duration: float, **kw):
    """One native scan over the whole clip, in parts of RECORD_PART frames
    resumed from the stream position: the outputs concatenated."""
    parts = []
    resume = False
    while True:
        out = scan(0.0, duration + 1.0, max_frames=RECORD_PART,
                   resume=resume, **kw)
        parts.append(out)
        if len(out[1]) < RECORD_PART:
            break
        resume = True
    return tuple(np.concatenate(p) for p in zip(*parts))


def oracle_concat(clip: str, cfg: Config) -> str:
    """The concat list that the oracle backend cuts the clip to, with the
    input path as INPUT_TOKEN ("" when it finds no motion)."""
    from ..pipeline.pipeline import ProcessingPipeline
    from ..utils.timing import TimingCollector

    with tempfile.TemporaryDirectory() as tmp:
        dump = os.path.join(tmp, "list.concat")
        env = os.environ.get("MVT_CONCAT_DUMP")
        os.environ["MVT_CONCAT_DUMP"] = dump
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = ProcessingPipeline(clip, os.path.join(tmp, "out.mp4"),
                                        cfg=dataclasses.replace(
                                            cfg, scan_backend="oracle",
                                            ffmpeg_bin=FAKE_FFMPEG)).run()
        finally:
            TimingCollector.clear()
            if env is None:
                os.environ.pop("MVT_CONCAT_DUMP", None)
            else:
                os.environ["MVT_CONCAT_DUMP"] = env
        if rc != 0:
            raise RuntimeError(f"the oracle backend failed on {clip}")
        if not os.path.exists(dump):
            return ""
        with open(dump) as f:
            return f.read().replace(os.path.abspath(clip), INPUT_TOKEN)


def record(clip: str, out_npz: str, cfg: Config | None = None, *,
           payloads=MV_PAYLOADS, synth: dict | None = None) -> dict:
    """Record the native scans of ``clip`` under ``cfg`` into ``out_npz``
    (``np.savez_compressed``): the MV payloads named in ``payloads`` with
    their pts and per-frame side-data flags, the luma where no frame
    carries MVs, the probe, the scan knobs, and the oracle backend's
    concat list.  Returns the metadata stored."""
    cfg = cfg or Config()
    with native.VideoReader(clip) as r:
        width, height, fps, duration = r.width, r.height, r.fps, r.duration
    knobs = scan_knobs(cfg, width, height)
    grid = {k: knobs[k] for k in ("gw", "gh", "y_min", "y_max")}
    thr = dict(threshold_sq=knobs["threshold_sq"],
               block_shift=knobs["block_shift"])
    arrays: dict[str, np.ndarray] = {}
    with native.VideoReader(clip) as r:
        # the side-data flags: a frame can carry side data and no MV
        grids, pts, has_mv = _scan_all(
            r.scan_grids_multi, duration, thresholds_sq=[thr["threshold_sq"]],
            block_shift=thr["block_shift"], **grid)
    arrays["pts"] = pts
    arrays["has_mv"] = has_mv
    if "grids" in payloads:
        arrays["grids"] = grids[:, 0]
    for name in ("bits", "words"):
        if name in payloads:
            with native.VideoReader(clip) as r:
                data, p = _scan_all(getattr(r, f"scan_{name}"), duration,
                                    **thr, **grid,
                                    vectors_needed=knobs["vectors_needed"])
            if not np.array_equal(p, pts):
                raise RuntimeError(f"scan_{name} served other frames")
            arrays[name] = data
    if "mvs" in payloads:
        with native.VideoReader(clip) as r:
            _, counts, p = _scan_all(r.scan_mvs, duration, max_mv=1)
        capacity = max(1, int(np.abs(counts).max(initial=0)))
        with native.VideoReader(clip) as r:
            mvs, counts, p = _scan_all(r.scan_mvs, duration,
                                       max_mv=capacity)
        if not np.array_equal(p, pts) or (counts < 0).any():
            raise RuntimeError("scan_mvs served other frames or overflowed")
        arrays["mv_counts"] = counts
        # field-major (dst_x, dst_y, src_x, src_y rows of every live MV):
        # compresses to about half of the MV-major layout
        arrays["mv_fields"] = np.ascontiguousarray(np.concatenate(
            [m[:c] for m, c in zip(mvs, counts)]
            + [np.zeros((0, 4), np.int16)]).T)
    if not has_mv.any():
        with native.VideoReader(clip, native.MVT_MODE_LUMA) as r:
            arrays["luma"], arrays["luma_pts"] = _scan_all(
                r.scan_luma, duration)
    meta = dict(width=width, height=height, fps=fps, duration=duration,
                knobs=knobs, config=_decision_config(cfg), synth=synth,
                payloads=sorted(set(payloads) | ({"luma"} if "luma" in arrays
                                                 else set())))
    arrays["meta"] = np.array(json.dumps(meta))
    arrays["concat"] = np.array(oracle_concat(clip, cfg))
    os.makedirs(os.path.dirname(os.path.abspath(out_npz)), exist_ok=True)
    np.savez_compressed(out_npz, **arrays)
    return meta


def _decision_config(cfg: Config) -> dict:
    """The Config fields that differ from the defaults: the replay runs
    under the same ones."""
    base = Config()
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(base, f.name)
            and f.name not in ("scan_backend", "ffmpeg_bin")}


class Fixture:
    """One recorded clip, decompressed: the arrays and the metadata."""

    def __init__(self, npz_path: str):
        with np.load(npz_path, allow_pickle=False) as z:
            self.arrays = {k: z[k] for k in z.files}
        self.name = os.path.splitext(os.path.basename(npz_path))[0]
        self.meta = json.loads(str(self.arrays.pop("meta")))
        self.concat_text = str(self.arrays.pop("concat"))
        self.pts = self.arrays["pts"]
        self.has_mv = self.arrays["has_mv"]
        counts = self.arrays.get("mv_counts")
        if counts is not None:
            self.mv_offsets = np.concatenate(
                [[0], np.cumsum(counts, dtype=np.int64)])

    def config(self, **fields) -> Config:
        """The recording's Config with the run's ``fields`` on top."""
        return Config(**{**self.meta["config"], **fields})

    def concat(self, input_path: str) -> str:
        """The stored concat list, naming ``input_path``."""
        return self.concat_text.replace(INPUT_TOKEN,
                                        os.path.abspath(input_path))

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())


@functools.lru_cache(maxsize=None)
def load(name_or_path: str) -> Fixture:
    """A fixture by name (``FIXTURES``) or by path, loaded once."""
    p = name_or_path if name_or_path.endswith(".npz") else path(name_or_path)
    return Fixture(p)


class ReplayReader:
    """A stand-in for ``native.VideoReader`` over one fixture.

    Each scan serves the recorded frames whose pts lie in [start, end), at
    most ``max_frames``; ``resume`` goes on from where the last scan
    stopped, and a scan that stopped at ``end`` has taken the frame there,
    as the native decoder has.  ``scan_mvs`` truncates each frame to
    ``max_mv`` rows and negates its count where the frame holds more, as
    the native scan marks an overflow; a ``timing`` counts the frames that
    carry MV side data, as the native MV scans do.  Other knobs than the
    recorded ones raise ``ValueError``."""

    def __init__(self, fixture: Fixture, mode: int = native.MVT_MODE_MV,
                 path: str = ""):
        self.fx = fixture
        self.mode = mode
        self.path = path or fixture.name
        meta = fixture.meta
        self.width, self.height = meta["width"], meta["height"]
        self.fps, self.duration = meta["fps"], meta["duration"]
        self.next = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        pass

    def _payload(self, name: str, mode: int) -> np.ndarray:
        if mode != self.mode:
            raise ValueError(f"replay {self.fx.name}: {name} asked of a "
                             f"reader opened in mode {self.mode}")
        key = "mv_fields" if name == "mvs" else name
        if key not in self.fx.arrays:
            raise ValueError(f"replay {self.fx.name}: {name} was not "
                             f"recorded (only {self.fx.meta['payloads']})")
        return self.fx.arrays[key]

    def _knobs(self, name: str, **asked) -> None:
        rec = self.fx.meta["knobs"]
        for key, value in asked.items():
            if value != rec[key]:
                raise ValueError(
                    f"replay {self.fx.name}: {name} asked {key}={value!r}, "
                    f"recorded at {rec[key]!r}")

    def _range(self, pts, start, end, frame_skip, max_frames, resume):
        self._knobs("scan", frame_skip=frame_skip)
        stop = int(np.searchsorted(pts, end))
        lo = self.next if resume else int(np.searchsorted(pts, start))
        hi = max(lo, min(lo + max(0, max_frames), stop))
        # a full part stops after its last frame; one that reached `end`
        # has decoded (and dropped) the frame there
        self.next = hi if hi - lo == max_frames else min(stop + 1, len(pts))
        return lo, hi

    def _count(self, timing, lo: int, hi: int) -> None:
        if timing is not None:
            timing.frames_with_mvs += int(self.fx.has_mv[lo:hi].sum())

    def _masks(self, name, start, end, *, threshold_sq, block_shift, gw, gh,
               y_min, y_max, vectors_needed, frame_skip, max_frames, timing,
               resume):
        data = self._payload(name, native.MVT_MODE_MV)
        self._knobs(name, threshold_sq=threshold_sq, block_shift=block_shift,
                    gw=gw, gh=gh, y_min=y_min, y_max=y_max,
                    vectors_needed=vectors_needed)
        lo, hi = self._range(self.fx.pts, start, end, frame_skip, max_frames,
                             resume)
        self._count(timing, lo, hi)
        return data[lo:hi].copy(), self.fx.pts[lo:hi].copy()

    def scan_bits(self, start, end, *, threshold_sq, block_shift, gw, gh,
                  y_min, y_max, vectors_needed, frame_skip=1,
                  max_frames=4096, timing=None, resume=False):
        return self._masks("bits", start, end, threshold_sq=threshold_sq,
                           block_shift=block_shift, gw=gw, gh=gh,
                           y_min=y_min, y_max=y_max,
                           vectors_needed=vectors_needed,
                           frame_skip=frame_skip, max_frames=max_frames,
                           timing=timing, resume=resume)

    def scan_words(self, start, end, *, threshold_sq, block_shift, gw, gh,
                   y_min, y_max, vectors_needed, frame_skip=1,
                   max_frames=4096, timing=None, resume=False):
        return self._masks("words", start, end, threshold_sq=threshold_sq,
                           block_shift=block_shift, gw=gw, gh=gh,
                           y_min=y_min, y_max=y_max,
                           vectors_needed=vectors_needed,
                           frame_skip=frame_skip, max_frames=max_frames,
                           timing=timing, resume=resume)

    def scan_grids(self, start, end, *, threshold_sq, block_shift, gw, gh,
                   y_min, y_max, frame_skip=1, max_frames=4096, timing=None,
                   resume=False):
        grids, pts, _ = self.scan_grids_multi(
            start, end, thresholds_sq=[threshold_sq], block_shift=block_shift,
            gw=gw, gh=gh, y_min=y_min, y_max=y_max, frame_skip=frame_skip,
            max_frames=max_frames, timing=timing, resume=resume)
        return grids[:, 0], pts

    def scan_grids_multi(self, start, end, *, thresholds_sq, block_shift,
                         gw, gh, y_min, y_max, frame_skip=1, max_frames=4096,
                         timing=None, resume=False):
        data = self._payload("grids", native.MVT_MODE_MV)
        thr = [float(t) for t in np.atleast_1d(thresholds_sq)]
        for t in thr:
            self._knobs("grids", threshold_sq=t)
        self._knobs("grids", block_shift=block_shift, gw=gw, gh=gh,
                    y_min=y_min, y_max=y_max)
        lo, hi = self._range(self.fx.pts, start, end, frame_skip, max_frames,
                             resume)
        self._count(timing, lo, hi)
        grids = np.repeat(data[lo:hi, None], len(thr), axis=1)
        return grids, self.fx.pts[lo:hi].copy(), self.fx.has_mv[lo:hi].copy()

    def scan_mvs(self, start, end, *, frame_skip=1, max_frames=4096,
                 max_mv=8192, timing=None, resume=False):
        rows = self._payload("mvs", native.MVT_MODE_MV)
        counts = self.fx.arrays["mv_counts"]
        offsets = self.fx.mv_offsets
        lo, hi = self._range(self.fx.pts, start, end, frame_skip, max_frames,
                             resume)
        self._count(timing, lo, hi)
        out = np.zeros((hi - lo, max_mv, 4), np.int16)
        for i in range(lo, hi):
            n = min(int(counts[i]), max_mv)
            out[i - lo, :n] = rows[:, offsets[i]:offsets[i] + n].T
        c = counts[lo:hi].astype(np.int32)
        return (out, np.where(c > max_mv, -c, c).astype(np.int32),
                self.fx.pts[lo:hi].copy())

    def scan_luma(self, start, end, *, frame_skip=1, max_frames=256,
                  timing=None, resume=False):
        luma = self._payload("luma", native.MVT_MODE_LUMA)
        pts = self.fx.arrays["luma_pts"]
        lo, hi = self._range(pts, start, end, frame_skip, max_frames, resume)
        return luma[lo:hi].copy(), pts[lo:hi].copy()


def opener(fixture: Fixture):
    """``native.VideoReader``'s stand-in over ``fixture``: (path, mode) ->
    ReplayReader, for every path (the probe and each decode worker)."""
    def open_reader(path, mode=native.MVT_MODE_MV):
        return ReplayReader(fixture, mode, path)
    return open_reader


def rebuild(names, out_dir: str = DATA_DIR) -> None:
    """Synthesize each named fixture's clip and record it into out_dir."""
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            spec = FIXTURES[name]
            clip = os.path.join(tmp, f"{name}.mp4")
            t0 = time.perf_counter()
            native.synthesize(clip, **spec.synth)
            t1 = time.perf_counter()
            out = os.path.join(out_dir, f"{name}.npz")
            meta = record(clip, out, Config(**spec.config),
                          payloads=spec.payloads, synth=spec.synth)
            print(f"{name}: synthesized in {t1 - t0:.1f} s, recorded "
                  f"{meta['payloads']} in {time.perf_counter() - t1:.1f} s "
                  f"-> {out} ({os.path.getsize(out)} B)", flush=True)
            os.remove(clip)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", action="store_true",
                    help="synthesize and record the fixtures (needs libav)")
    ap.add_argument("--only", default=",".join(FIXTURES),
                    help="comma-separated fixture names")
    ap.add_argument("--out", default=DATA_DIR)
    args = ap.parse_args(argv)
    names = [n for n in args.only.split(",") if n]
    if args.record:
        rebuild(names, args.out)
    for name in names:
        npz = os.path.join(args.out, f"{name}.npz")
        fx = load(npz)
        print(f"{name}: {json.dumps(fx.meta['synth'])} payloads "
              f"{fx.meta['payloads']}, {len(fx.pts)} frames, "
              f"{fx.concat_text.count('inpoint')} segments, "
              f"{os.path.getsize(npz)} B on disk, {fx.nbytes()} B loaded")
    return 0


if __name__ == "__main__":
    sys.exit(main())
