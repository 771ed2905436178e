"""The capacity the mv_raw scan asks each decode call for.

A call whose frames overflow the capacity restarts its chunk at
``mv_restart_capacity`` of the call's largest count: an eighth of
headroom in steps of 1,024 rows, never above the power of two that holds
the count, and that power of two where the call stopped at its frame cap
short of the chunk's end.  The capacity is the file's, shared by its decode workers: it
starts at ``MVT_MV_CAPACITY``, only grows, and each chunk's first call
asks for it (a ``scan.mv_carried`` span where it is above
``MVT_MV_CAPACITY``).  Files are replayed through the port's pipeline
(plain build) from fixture B and from the benchmark's 1080p raw-MV pool;
decisions are held to a run at a fixed capacity and to the benchmark's
plain reference.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import threading

import numpy as np
import pytest

from mvtrim_tpu_torch.bench import replay
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.pipeline import pipeline
from mvtrim_tpu_torch.pipeline.pipeline import (ProcessingPipeline,
                                                mv_restart_capacity)
from mvtrim_tpu_torch.utils import timing
from mvtrim_tpu_torch.utils.timing import TimingCollector
from trimbench import scene, spec
from trimbench.reference import mvs as ref_mvs
from trimbench.reference import rule
from trimbench.reference import segments as ref_segments


def pow2(m: int) -> int:
    return 1 << (m - 1).bit_length()


# --- the restart's capacity ---

@pytest.mark.parametrize("largest,want", [
    (8193, 10240),      # 9,217 rounds up to 10 x 1,024, under 16,384
    (16383, 16384),     # 18,430 would pass the power of two
    (16384, 16384),
    (23436, 26624),     # 26,365 rounds up to 26 x 1,024
    (32769, 37888),     # 36,865 rounds up to 37 x 1,024, under 65,536
    (300, 512),         # small counts keep the power of two
])
def test_restart_capacity_at_edge_counts(largest, want):
    assert mv_restart_capacity(largest) == want
    assert want == min(pow2(largest),
                       -(-(largest + largest // 8) // 1024) * 1024)
    # a call cut short by its frame cap takes the power of two
    assert mv_restart_capacity(largest, unseen=True) == pow2(largest)


def test_restart_capacity_holds_the_count_and_never_passes_its_power():
    for m in range(1, 70_000, 7):
        cap = mv_restart_capacity(m)
        assert m <= cap <= pow2(m), m
        assert cap == pow2(m) or (cap % 1024 == 0
                                  and cap >= m + m // 8), m


# --- files replayed through the pipeline ---

def as_fixture(fields, counts, idx, side, meta, name):
    """A replay fixture of the frames ``idx`` of a pool (fields int16
    [E, W, 4], counts [E]) at 25 fps; ``side``: which carry MV side data."""
    fx = object.__new__(replay.Fixture)
    fx.name = name
    fx.meta = dict(meta, fps=25.0, duration=len(idx) / 25.0,
                   knobs=dict(frame_skip=1), payloads=["mvs"])
    fx.pts = np.arange(len(idx)) / 25.0
    fx.has_mv = np.asarray(side, bool)
    c = counts[idx].astype(np.int32)
    fx.arrays = {"pts": fx.pts, "has_mv": fx.has_mv, "mv_counts": c,
                 "mv_fields": np.ascontiguousarray(np.concatenate(
                     [fields[i, :counts[i]] for i in idx]).T)}
    fx.mv_offsets = np.concatenate([[0], np.cumsum(c, dtype=np.int64)])
    fx.concat_text = ""
    return fx


@pytest.fixture(scope="module")
def pool():
    """The benchmark's 1080p raw-MV pool, its grid, knobs and scene."""
    cfg = spec.load_config("cctv1080_h264_mvraw")
    camera, knobs = cfg["camera"], cfg["env"]
    geom = rule.Geometry.of(camera["width"], camera["height"], knobs)
    sc = scene.build("mvs", camera, cfg["scene"]["mvs"], geom, 2 ** 31 + 91)
    return sc, geom, knobs


def steady_file(pool, seconds: int):
    """A noisy camera's file: every second cycles the same 20 static
    frames (the pool's largest among them) and an I-frame every 50, with
    one object crossing seconds 3-5."""
    sc, geom, _ = pool
    fields, counts = sc.pool
    static = 1 + np.argsort(counts[1:1 + sc.static_n])[::-1][:20]
    n = 25 * seconds
    idx = static[np.arange(n) % len(static)]
    moving = (np.arange(n) >= 75) & (np.arange(n) < 125)
    idx[moving] = 1 + sc.static_n + np.arange(moving.sum()) % sc.track_frames
    side = np.arange(n) % 50 != 0
    idx[~side] = 0
    meta = dict(width=geom.width, height=geom.height)
    return as_fixture(fields, counts, idx, side, meta, "steady"), idx


def quiet_file(pool, seconds: int):
    """A quiet camera's file: static frames that all fit 8,192."""
    sc, geom, _ = pool
    fields, counts = sc.pool
    quiet = 1 + np.flatnonzero((counts[1:1 + sc.static_n] > 0)
                               & (counts[1:1 + sc.static_n] <= 8192))
    n = 25 * seconds
    idx = quiet[np.arange(n) % len(quiet)]
    side = np.arange(n) % 50 != 0
    idx[~side] = 0
    meta = dict(width=geom.width, height=geom.height)
    return as_fixture(fields, counts, idx, side, meta, "quiet"), idx


def pool_config(pool, **fields) -> Config:
    knobs = pool[2]
    return dataclasses.replace(
        Config(), scan_backend="torch", scan_input="mv_raw",
        mv_threshold_sq=float(knobs["MV_THRESHOLD_SQ"]),
        ffmpeg_bin=replay.FAKE_FFMPEG, **fields)


Call = collections.namedtuple("Call",
                              "thread start max_mv resume largest unseen")
Run = collections.namedtuple("Run", "concat calls spans scan src")


def run(fx, cfg, tmp_path, monkeypatch, name="f") -> Run:
    """The pipeline over ``fx``: its concat list (None without a cut),
    each decode call, the program's spans and the scan's result."""
    calls = []

    class Traced(replay.ReplayReader):
        def scan_mvs(self, start, end, **kw):
            out = super().scan_mvs(start, end, **kw)
            calls.append(Call(threading.current_thread().name, start,
                              kw["max_mv"], kw["resume"],
                              int(np.abs(out[1]).max(initial=0)),
                              len(out[2]) == kw["max_frames"]))
            return out

    src = str(tmp_path / f"{name}.mp4")
    dump = str(tmp_path / f"{name}.concat")
    monkeypatch.setenv("MVT_CONCAT_DUMP", dump)
    monkeypatch.setattr(native, "VideoReader",
                        lambda path, mode=0: Traced(fx, mode, path))
    pipe = ProcessingPipeline(src, src + ".out", cfg=cfg)
    scans = []
    scan = pipe._parallel_scan
    pipe._parallel_scan = lambda *a: scans.append(scan(*a)) or scans[-1]
    timing.start_recording()
    try:
        assert pipe.run() == 0
    finally:
        spans = timing.stop_recording()
        TimingCollector.clear()
    concat = None   # no cut: no concat list
    if os.path.exists(dump):
        with open(dump) as f:
            concat = f.read()
    (result,) = scans
    return Run(concat, calls, spans, result, src)


def chunks_of(calls):
    """Each chunk's calls, in order, keyed by (thread, chunk start)."""
    out = collections.defaultdict(list)
    for c in calls:
        out[(c.thread, c.start)].append(c)
    return out


def values(spans, name):
    return [s.value for s in spans if s.name == name]


def check_calls(calls, cfg):
    """What every run must show: a restart asks for
    ``mv_restart_capacity`` of its call's largest count, no call for more
    than the power of two that holds the file's largest (the largest that
    a scan at the power of two alone asks for), and no call of a worker
    for less than a capacity the worker chose before (the file's
    capacity only grows)."""
    top = max(c.largest for c in calls)
    assert all(c.max_mv <= max(cfg.mv_capacity, pow2(top)) for c in calls)
    for chunk in chunks_of(calls).values():
        for before, after in zip(chunk, chunk[1:]):
            if before.largest > before.max_mv:
                assert after.max_mv == mv_restart_capacity(before.largest,
                                                           before.unseen)
                assert not after.resume
    chosen = collections.defaultdict(int)
    for c in calls:
        assert c.max_mv >= chosen[c.thread]
        if c.largest > c.max_mv:
            chosen[c.thread] = mv_restart_capacity(c.largest, c.unseen)


def test_a_steady_file_restarts_only_its_first_chunk(pool, tmp_path,
                                                     monkeypatch):
    """One worker over 8 chunks that all pass 8,192: the first chunk
    restarts once, the other seven start at the carried capacity."""
    fx, idx = steady_file(pool, 8)
    per_chunk = fx.arrays["mv_counts"].reshape(8, 25).max(axis=1)
    cap = mv_restart_capacity(int(per_chunk[0]))
    assert (per_chunk > 8192).all()
    assert per_chunk.max() <= cap < pow2(int(per_chunk.max()))
    cfg = pool_config(pool, chunk_duration_sec=1.0, decode_workers=1)
    r = run(fx, cfg, tmp_path, monkeypatch)
    check_calls(r.calls, cfg)
    assert [c.max_mv for c in r.calls] == [8192] + [cap] * 8
    assert values(r.spans, "scan.mv_restart") == [25]
    assert values(r.spans, f"scan.mv_capacity.{cap}") == [cap]
    assert values(r.spans, "scan.mv_carried") == [cap] * 7
    assert sum(values(r.spans, "scan.decode")) == len(idx) + 25


def test_a_chunk_past_the_carried_capacity_restarts_and_raises_it(
        tmp_path, monkeypatch):
    """Fixture B in 1-s chunks on one worker: its counts rise, so the
    carried capacity is passed once more on the way."""
    fx = replay.load("B")
    counts = fx.arrays["mv_counts"]
    chunk = fx.pts.astype(int)
    assert chunk.max() == 9
    top = [int(counts[chunk == k].max()) for k in range(10)]
    # chunk 0 reaches 17,489 -> 20,480, which holds chunks 1-3; chunk 4
    # reaches 22,479 -> 25,600, which holds the rest (23,729 at most)
    assert top[0] == 17489 and mv_restart_capacity(17489) == 20480
    assert max(top[1:4]) <= 20480 < top[4] == 22479
    assert mv_restart_capacity(22479) == 25600 >= max(top[4:])
    cfg = fx.config(scan_backend="torch", scan_input="mv_raw",
                    chunk_duration_sec=1.0, decode_workers=1,
                    ffmpeg_bin=replay.FAKE_FFMPEG)
    r = run(fx, cfg, tmp_path, monkeypatch)
    assert r.concat == fx.concat(r.src)
    check_calls(r.calls, cfg)
    assert [c.max_mv for c in r.calls] == \
        [8192, 20480, 20480, 20480, 20480, 20480, 25600] + [25600] * 5
    assert values(r.spans, "scan.mv_carried") == [20480] * 4 + [25600] * 5
    assert [s.name for s in r.spans
            if s.name.startswith("scan.mv_capacity.")] == \
        ["scan.mv_capacity.20480", "scan.mv_capacity.25600"]
    assert values(r.spans, "scan.mv_restart") == [
        int((chunk == 0).sum()), int((chunk == 4).sum())]


@pytest.mark.parametrize("frames_cap", [2, 5, 8, 25, 40])
def test_sub_calls_restart_as_at_the_power_of_two_alone(
        frames_cap, tmp_path, monkeypatch):
    """Fixture B in one chunk, decoded a few frames a call: its counts
    rise from call to call, so a restart with headroom would be passed
    again within the chunk.  A call cut short by the frame cap restarts
    at the power of two, so the chunk restarts where and as often as at
    the power of two alone, and never at a larger capacity."""
    fx = replay.load("B")
    cfg = fx.config(scan_backend="torch", scan_input="mv_raw",
                    chunk_frames_cap=frames_cap,
                    ffmpeg_bin=replay.FAKE_FFMPEG)
    got = run(fx, cfg, tmp_path, monkeypatch, "got")
    monkeypatch.setattr(pipeline, "mv_restart_capacity",
                        lambda m, unseen=False: pow2(m))
    alone = run(fx, cfg, tmp_path, monkeypatch, "alone")
    check_calls(got.calls, cfg)
    assert len(chunks_of(got.calls)) == 1
    assert values(got.spans, "scan.mv_restart") == \
        values(alone.spans, "scan.mv_restart")
    assert [c.max_mv <= a.max_mv for c, a in zip(got.calls, alone.calls)] \
        == [True] * len(alone.calls) and len(got.calls) == len(alone.calls)
    assert got.concat == fx.concat(got.src)
    assert alone.concat == fx.concat(alone.src)


def test_a_quiet_file_makes_the_same_calls_as_before(pool, tmp_path,
                                                      monkeypatch):
    """A file that never passes 8,192 asks every call for 8,192 and
    neither restarts nor carries: a call a chunk, as without the carry."""
    fx, _ = quiet_file(pool, 6)
    assert 0 < fx.arrays["mv_counts"].max() <= 8192
    cfg = pool_config(pool, chunk_duration_sec=1.0, decode_workers=2)
    r = run(fx, cfg, tmp_path, monkeypatch)
    assert sorted(c.start for c in r.calls) == [float(s) for s in range(6)]
    assert {c.max_mv for c in r.calls} == {8192}
    assert not any(c.resume for c in r.calls)
    assert not [s for s in r.spans if s.name.startswith(
        ("scan.mv_restart", "scan.mv_capacity.", "scan.mv_carried"))]


@pytest.fixture
def fast_switches():
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(before)


@pytest.mark.parametrize("workers", [2, 6])
def test_workers_share_the_files_capacity(pool, workers, tmp_path,
                                          monkeypatch, fast_switches):
    """Under a 1-us switch interval, each worker restarts at most its
    first chunk; every other chunk starts at the carried capacity."""
    fx, _ = steady_file(pool, 12)
    per_chunk = fx.arrays["mv_counts"].reshape(12, 25).max(axis=1)
    assert (per_chunk > 8192).all()
    assert per_chunk.max() <= mv_restart_capacity(int(per_chunk.min()))
    cfg = pool_config(pool, chunk_duration_sec=1.0, decode_workers=workers)
    r = run(fx, cfg, tmp_path, monkeypatch)
    check_calls(r.calls, cfg)
    chunks = chunks_of(r.calls)
    assert len(chunks) == 12
    first = {}
    for (thread, start), calls in sorted(chunks.items(),
                                         key=lambda kv: kv[0][1]):
        first.setdefault(thread, start)
        restarted = len(calls) == 2
        assert len(calls) <= 2
        assert not restarted or start == first[thread]
        assert (calls[0].max_mv > 8192) != restarted
    restarts = values(r.spans, "scan.mv_restart")
    assert 1 <= len(restarts) <= workers
    assert len(values(r.spans, "scan.mv_carried")) == 12 - len(restarts)


@pytest.mark.parametrize("source", ["fixture_b", "pool"])
def test_decisions_match_a_fixed_capacity_and_the_reference(
        source, pool, tmp_path, monkeypatch):
    """The carry and the restarts decide every frame as a run at a fixed
    32,768 does, and as the plain reference does: the same motion
    timestamps, frames with MVs and concat list."""
    if source == "fixture_b":
        fx = replay.load("B")
        k = fx.meta["knobs"]
        geom = rule.Geometry(fx.meta["width"], fx.meta["height"], 16,
                             k["gw"], k["gh"], k["y_min"], k["y_max"])
        counts = fx.arrays["mv_counts"].astype(np.int32)
        rows = fx.arrays["mv_fields"].T
        fields = np.zeros((len(counts), counts.max(), 4), np.int16)
        for i, (lo, hi) in enumerate(zip(fx.mv_offsets[:-1],
                                         fx.mv_offsets[1:])):
            fields[i, :hi - lo] = rows[lo:hi]
        idx = np.arange(len(counts))
        cfg = fx.config(scan_backend="torch", scan_input="mv_raw",
                        ffmpeg_bin=replay.FAKE_FFMPEG)
    else:
        fx, idx = steady_file(pool, 8)
        (fields, counts), geom = pool[0].pool, pool[1]
        cfg = pool_config(pool)
    cfg = dataclasses.replace(cfg, chunk_duration_sec=1.0, decode_workers=2)
    got = run(fx, cfg, tmp_path, monkeypatch)
    fixed = run(fx, dataclasses.replace(cfg, mv_capacity=32768), tmp_path,
                monkeypatch)
    assert values(got.spans, "scan.mv_restart")
    assert values(got.spans, "scan.mv_carried")
    assert {c.max_mv for c in fixed.calls} == {32768}
    knobs = dict(MV_THRESHOLD_SQ=cfg.mv_threshold_sq,
                 BLOCK_SHIFT=cfg.block_shift,
                 VECTORS_NEEDED=cfg.vectors_needed,
                 CLUSTERS_NEEDED=cfg.clusters_needed,
                 MAX_GAP_SEC=cfg.max_gap_sec, PADDING_SEC=cfg.padding_sec,
                 MIN_SAVINGS_PCT=cfg.min_savings_pct)
    motion = ref_mvs.Decider((fields, counts), geom, knobs)(idx, None)
    assert motion.any() and not motion.all()
    _, want = ref_segments.cut_of(fx.pts[motion], fx.meta["duration"],
                                  os.path.abspath(got.src), knobs)
    assert got.concat == fixed.concat == want
    for r in (got, fixed):
        assert sorted(r.scan.motion_ts) == fx.pts[motion].tolist()
        assert r.scan.frames_scanned == len(idx)
        assert r.scan.frames_with_mvs == int(fx.has_mv.sum())
    assert sum(values(got.spans, "scan.decode")) - sum(values(
        got.spans, "scan.mv_restart")) == len(idx)
    assert sum(values(got.spans, "detector.mv_rows")) == \
        sum(values(fixed.spans, "detector.mv_rows")) == int(counts[idx].sum())


def test_rising_counts_on_six_workers_never_lower_the_capacity(
        tmp_path, monkeypatch, fast_switches):
    """Fixture B's counts rise from chunk to chunk, so its six workers'
    restarts choose different capacities at about the same time: under a
    1-us switch interval, no worker's chunk starts below a capacity the
    worker chose before (an update of the file's capacity lost to another
    worker's smaller one would), and the cut stays the stored one."""
    fx = replay.load("B")
    cfg = fx.config(scan_backend="torch", scan_input="mv_raw",
                    chunk_duration_sec=1.0, decode_workers=6,
                    ffmpeg_bin=replay.FAKE_FFMPEG)
    for k in range(5):
        r = run(fx, cfg, tmp_path, monkeypatch, f"b{k}")
        check_calls(r.calls, cfg)
        assert len(values(r.spans, "scan.mv_restart")) >= 2
        assert r.concat == fx.concat(r.src)
