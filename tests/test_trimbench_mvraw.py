"""The benchmark's raw-MV cell (``mvraw1080_nvr``, configuration
``cctv1080_h264_mvraw``) on the CPU, at a 320x400 camera.

The payload (``trimbench/scene/mvs.py``) is served as the native
``scan_mvs`` and the replay reader serve it; the plain reference
(``trimbench/reference/mvs.py``) decides as the port's plain K4+K5 and the
oracle do; whole runs of the cell are correct, and wrong under three
faults planted in the raw-MV payload's overflow restart; the restart's
and the live rows' spans carry their values; the cell's readers read
them, and read nothing where there is nothing.
"""

from __future__ import annotations

import ast
import copy
import inspect
import json
import os
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from mvtrim_tpu_torch.bench import replay
from mvtrim_tpu_torch.core import oracle
from mvtrim_tpu_torch.core.types import GridGeometry
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.ops import mv_vote
from mvtrim_tpu_torch.pipeline import payloads
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.utils import timing
from mvtrim_tpu_torch.utils.timing import TimingCollector
from trimbench import harness, roofline_mv, scene, spec, standin
from trimbench import trace
from trimbench.program import ProgramSpan
from trimbench.record import Run
from trimbench.reference import mvs as ref_mvs
from trimbench.reference import rule

CELL = "mvraw1080_nvr"
READERS = ("k45_roofline_pct", "mv_payload_fill_pct", "mv_redecode_pct",
           "h2d_gbps")
# the camera of the CPU runs: its grid masks a row at the top and the
# bottom (25 rows), and its frames hold 370-1,450 MVs
CAMERA = dict(width=320, height=400)
CPU_ENV = {"MVT_SCAN_BACKEND": "torch", "MVT_MV_CAPACITY": "512"}
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def clear_timing():
    yield
    TimingCollector.clear()


def small_cell(files: int, duration_s=None) -> spec.Cell:
    cell = spec.cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["camera"].update(CAMERA)
    lo, hi = cell.traffic["duration_s"]
    cell.traffic = dict(cell.traffic, files=files,
                        duration_s=duration_s or [lo / 10, hi / 10],
                        warm={"files": 1, "duration_s": 12})
    return cell


def run_small(files: int, env=None, duration_s=None) -> dict:
    return harness.run_cell(small_cell(files, duration_s), SEED, 120.0,
                            False, t_start=time.perf_counter(),
                            require_cuda=False, env={**CPU_ENV, **(env or {})})


def small_scene():
    cell = small_cell(1)
    camera, knobs = cell.config["camera"], cell.config["env"]
    geom = rule.Geometry.of(camera["width"], camera["height"], knobs)
    return scene.build("mvs", camera, cell.config["scene"]["mvs"], geom,
                       SEED), geom, knobs


# --- (a) the payload, served as the native scan serves it ---

def recorded_as_fixture(sc, path: str) -> replay.Fixture:
    """The scene's pool as a replay fixture, a frame an entry."""
    fields, counts = sc.pool
    n = len(counts)
    rows = np.concatenate([fields[e, :counts[e]] for e in range(n)])
    meta = dict(width=CAMERA["width"], height=CAMERA["height"], fps=25.0,
                duration=n / 25.0, knobs=dict(frame_skip=1), config={},
                synth=None, payloads=["mvs"])
    np.savez(path, pts=np.arange(n) / 25.0, has_mv=counts > 0,
             mv_counts=counts, mv_fields=np.ascontiguousarray(rows.T),
             meta=np.array(json.dumps(meta)), concat=np.array(""))
    return replay.load(path)


@pytest.mark.parametrize("cap", [256, 512, 2048])
def test_served_as_the_replay_reader_truncates(cap, tmp_path):
    sc, _, _ = small_scene()
    fields, counts = sc.pool
    assert counts.max() > 512 and (counts > 256).mean() > 0.5
    fx = recorded_as_fixture(sc, str(tmp_path / "pool.npz"))
    want, want_counts, _ = replay.ReplayReader(fx).scan_mvs(
        0.0, fx.meta["duration"] + 1, max_frames=len(counts), max_mv=cap)
    sc.check({"max_mv": cap})
    got, got_counts = sc.serve(np.arange(len(counts)))
    assert got.dtype == np.int16 and got.shape == (len(counts), cap, 4)
    assert got_counts.dtype == np.int32
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(got, want)
    over = counts > cap
    np.testing.assert_array_equal(got_counts[over], -counts[over])
    for e in np.flatnonzero(~over):
        assert not got[e, counts[e]:].any()


def test_capacities_asked_at_once_on_three_threads():
    sc, _, _ = small_scene()
    fields, counts = sc.pool
    idx = np.arange(len(counts))[::-1].copy()
    caps = (256, 512, 2048)
    barrier = threading.Barrier(len(caps))
    faults = []

    def expected(cap):
        out = np.zeros((len(idx), cap, 4), np.int16)
        for i, e in enumerate(idx):
            k = min(cap, counts[e])
            out[i, :k] = fields[e, :k]
        c = counts[idx]
        return out, np.where(c > cap, -c, c)

    def worker(cap):
        want, want_counts = expected(cap)
        for _ in range(12):
            sc.check({"max_mv": cap})
            barrier.wait()  # the others ask for theirs in between
            got, got_counts = sc.serve(idx)
            if not (np.array_equal(got, want)
                    and np.array_equal(got_counts, want_counts)):
                faults.append(cap)

    threads = [threading.Thread(target=worker, args=(c,)) for c in caps]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert faults == []
    # a fresh array each call
    a, _ = sc.serve(idx[:2])
    b, _ = sc.serve(idx[:2])
    assert not np.shares_memory(a, b)


def test_i_frames_carry_no_mvs_and_other_arguments_raise():
    sc, _, _ = small_scene()
    file_spec = scene.FileSpec("f", 260, 25.0, ((60, 120, 3),))
    idx, side = sc.index(file_spec, 0, 260)
    assert list(np.flatnonzero(~side)) == [0, 50, 100, 150, 200, 250]
    assert (idx[~side] == 0).all() and sc.pool[1][0] == 0
    assert (sc.pool[1][idx[side]] > 0).all()
    assert (idx[60:120][side[60:120]] > sc.static_n).all()
    with pytest.raises(RuntimeError):
        sc.check({"max_mv": 512, "gw": 20})


def test_the_1080p_pool_is_calibrated_on_fixture_b():
    cfg = spec.load_config("cctv1080_h264_mvraw")
    camera, knobs = cfg["camera"], cfg["env"]
    geom = rule.Geometry.of(camera["width"], camera["height"], knobs)
    sc = scene.build("mvs", camera, cfg["scene"]["mvs"], geom, SEED)
    fields, counts = sc.pool
    assert fields.nbytes <= 100e6
    static = counts[1:1 + sc.static_n]
    moving = counts[1 + sc.static_n:]
    assert 0.7 <= (static > 8192).mean() <= 0.95
    assert (moving > 8192).all() and counts.max() <= 23729
    motion = ref_mvs.Decider(sc.pool, geom, knobs).motion
    assert not motion[:1 + sc.static_n].any()
    assert motion[1 + sc.static_n:].all()
    # a list cut to the capacity loses motion in the lower rows
    cut = ref_mvs.decide(fields, np.minimum(counts, 8192), geom, knobs)
    assert (cut != motion).sum() > 10


# --- (b) the reference against the port's plain K4+K5 and the oracle ---

KNOBS = [dict(MV_THRESHOLD_SQ=16, BLOCK_SHIFT=4, VECTORS_NEEDED=2,
              CLUSTERS_NEEDED=2, BLOCK_SIZE=16, VERTICAL_MASK=0.2),
         dict(MV_THRESHOLD_SQ=0.5, BLOCK_SHIFT=3, VECTORS_NEEDED=1,
              CLUSTERS_NEEDED=1, BLOCK_SIZE=8, VERTICAL_MASK=0.1),
         dict(MV_THRESHOLD_SQ=64.25, BLOCK_SHIFT=4, VECTORS_NEEDED=3,
              CLUSTERS_NEEDED=0, BLOCK_SIZE=16, VERTICAL_MASK=0.05)]


def random_pool(rng, geom: rule.Geometry, shift: int, entries: int = 40,
                m: int = 300):
    """Fields clustered on a small grid, with int16 extremes (magnitudes
    that wrap), negative dst, rows outside [y_min, y_max) and counts of
    0 and of the whole capacity."""
    side = 1 << shift
    f = np.zeros((entries, m, 4), np.int64)
    f[..., 0] = rng.integers(-2 * side, geom.gw * side + side, (entries, m))
    f[..., 1] = rng.integers(-2 * side, geom.gh * side + side, (entries, m))
    f[..., 2] = f[..., 0] - rng.integers(-12, 13, (entries, m))
    f[..., 3] = f[..., 1] - rng.integers(-12, 13, (entries, m))
    extreme = rng.random((entries, m)) < 0.05
    f[extreme, 2] = np.where(rng.random(extreme.sum()) < 0.5, -32768, 32767)
    f[extreme, 0] = np.where(f[extreme, 2] < 0, 32767, -32768) \
        * (rng.random(extreme.sum()) < 0.5)
    fields = np.clip(f, -32768, 32767).astype(np.int16)
    counts = rng.integers(0, m + 1, entries).astype(np.int32)
    counts[:3] = (0, m, 1)
    return fields, counts


@pytest.mark.parametrize("knobs", KNOBS, ids=["default", "loose", "strict"])
def test_reference_agrees_with_plain_and_oracle(knobs):
    rng = np.random.default_rng(7)
    width, height = 160, 120
    geom = rule.Geometry.of(width, height, knobs)
    shift = int(knobs["BLOCK_SHIFT"])
    fields, counts = random_pool(rng, geom, shift)
    mag = ref_mvs.magnitude(fields)
    assert (mag < 0).any()            # some magnitudes wrapped
    assert (fields[..., 0] < 0).any()
    got = ref_mvs.Decider((fields, counts), geom, knobs).motion
    assert 0 < got.sum() < len(got) - 1

    g = GridGeometry(width=width, height=height, gw=geom.gw, gh=geom.gh,
                     y_min=geom.y_min, y_max=geom.y_max)
    bound = mv_vote.threshold_bound(knobs["MV_THRESHOLD_SQ"])
    plain = mv_vote.mv_cluster_counts_plain(
        torch.from_numpy(fields), torch.from_numpy(counts), g, bound,
        knobs["VECTORS_NEEDED"], shift).numpy()
    need = max(1, knobs["CLUSTERS_NEEDED"])
    np.testing.assert_array_equal(got, (plain >= need) & (counts > 0))
    want = [oracle.check_frame(
        fields[e, :counts[e]].astype(np.int64), geom.gw, geom.gh,
        threshold_sq=knobs["MV_THRESHOLD_SQ"], block_shift=shift,
        y_min=geom.y_min, y_max=geom.y_max,
        vectors_needed=knobs["VECTORS_NEEDED"],
        clusters_needed=knobs["CLUSTERS_NEEDED"])
        for e in range(len(counts))]
    np.testing.assert_array_equal(got, want)


def test_reference_votes_by_arithmetic_shifts_and_masked_rows():
    knobs = KNOBS[0]
    geom = rule.Geometry.of(160, 160, knobs)   # 10 x 10, rows [2, 8)
    assert (geom.y_min, geom.y_max) == (2, 8)

    def mv(x, y, dx=8):
        return (x, y, x - dx, y)

    # active cells (4, 1) and (6, 1); dst_x = -5 beside each would be
    # column 0 by truncation toward zero: two clusters
    rows = [mv(20, 4 * 16 + 3)] * 2 + [mv(-5, 4 * 16 + 3)] * 2 \
        + [mv(20, 6 * 16 + 3)] * 2 + [mv(-5, 6 * 16 + 3)] * 2
    # active cells (2, 5) and (2, 8) under votes in masked row 1
    rows += [mv(5 * 16 + 4, 2 * 16 + 4)] * 2 + [mv(5 * 16 + 4, 16 + 4)] * 2
    rows += [mv(8 * 16 + 4, 2 * 16 + 4)] * 2 + [mv(8 * 16 + 4, 16 + 4)] * 2
    fields = np.array([rows], np.int16)
    counts = np.array([len(rows)], np.int32)
    assert not ref_mvs.decide(fields, counts, geom, knobs)[0]
    # the same votes inside the window cluster
    near = fields.copy()
    near[0, 2:4, 0] = near[0, 2:4, 2] = 4   # column 0
    near[0, 2:4, 2] -= 8
    near[0, 6:8, 0] = 4
    near[0, 6:8, 2] = -4
    assert ref_mvs.decide(near, counts, geom, knobs)[0]


def test_reference_imports_nothing_of_the_program():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in ("trimbench/reference/mvs.py", "trimbench/roofline_mv.py",
                "trimbench/scene/mvs.py"):
        with open(os.path.join(root, rel)) as f:
            tree = ast.parse(f.read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
        assert not names & {"mvtrim_tpu_torch", "mvtrim_tpu", "jax",
                            "jaxlib", "torch"}, (rel, names)


# --- (c) whole runs of the small cell ---

def test_a_small_run_whose_chunks_overflow_is_correct(monkeypatch):
    asked = []
    real = standin.Reader._scan

    def _scan(self, payload, *args, **kw):
        asked.append(kw.get("max_mv"))
        return real(self, payload, *args, **kw)

    monkeypatch.setattr(standin.Reader, "_scan", _scan)
    result = run_small(8)
    assert result["correct"], result["faults"]
    assert result["checks"]["files_checked"]["value"] >= 8
    assert 512 in asked and {1024, 2048} & set(asked)
    assert result["device"]["platform"] == "cpu"


# --- (d) planted faults in the overflow restart ---

def truncate(counts, cap) -> bool:
    """A restart left out: the overflowed frames' counts become their
    truncated lists' lengths, and no restart is asked for."""
    np.minimum(np.abs(counts, out=counts), cap, out=counts)
    return False


FAULTS = {
    "decides_truncated_lists": (
        "if n and (counts < 0).any():",
        "if n and _truncate(counts, chunk.cap):", "files_wrong_motion"),
    "keeps_replayed_duplicates": (
        "chunk.skip = chunk.emitted", "chunk.skip = 0", "files_wrong_frames"),
    "counts_side_data_twice": (
        "chunk.timing.frames_with_mvs = chunk.mv_base", "pass",
        "files_wrong_frames"),
}
# one frame a scan call: a chunk's first frame (an I-frame) is queued
# before the next overflows, so the restart replays it
FAULT_ENV = {"MVT_MV_CAPACITY": "256", "MVT_CHUNK_FRAMES_CAP": "1"}


def planted(old: str, new: str):
    """The raw-MV payload's chunk decode (``payloads.MvRaw.part``) with one
    line changed."""
    source = textwrap.dedent(inspect.getsource(payloads.MvRaw.part))
    assert source.count(old) == 1, old
    namespace = dict(vars(payloads), _truncate=truncate)
    exec(compile(source.replace(old, new), payloads.__file__, "exec"),
         namespace)
    return namespace["part"]


def test_the_faults_run_is_correct_unbroken():
    result = run_small(4, FAULT_ENV, [20, 40])
    assert result["correct"], result["faults"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_restart_is_not_correct(monkeypatch, fault):
    old, new, number = FAULTS[fault]
    monkeypatch.setattr(payloads.MvRaw, "part", planted(old, new))
    result = run_small(4, FAULT_ENV, [20, 40])
    assert not result["correct"]
    assert result["checks"][number]["value"] > 0
    assert result["checks"]["files_failed"]["value"] == 0


# --- (e) the spans, on fixture B replayed with two frames a call ---

@pytest.fixture(scope="module")
def b_spans(tmp_path_factory):
    """Fixture B through the port's mv_raw pipeline (plain build), two
    frames a scan call, with the program's spans recorded."""
    fx = replay.load("B")
    src = str(tmp_path_factory.mktemp("b") / "b.mp4")
    real = native.VideoReader
    native.VideoReader = replay.opener(fx)
    try:
        timing.start_recording()
        try:
            rc = ProcessingPipeline(src, src + ".out", cfg=fx.config(
                scan_backend="torch", scan_input="mv_raw",
                chunk_frames_cap=2, ffmpeg_bin=replay.FAKE_FFMPEG)).run()
        finally:
            spans = timing.stop_recording()
    finally:
        native.VideoReader = real
        TimingCollector.clear()
    assert rc == 0
    return fx, spans


def test_restart_spans_carry_the_frames_decoded_in_vain(b_spans):
    fx, spans = b_spans
    counts = fx.arrays["mv_counts"]
    # two frames a call at 8,192: frames 0-1 fit and are queued; 2-3
    # overflow (10,817 at most) -> 16,384, 2 + 2 frames in vain; the
    # restart drops 0-1, queues 2-3, and 4-5 overflow (17,489) -> 32,768,
    # 2 + 4 in vain
    assert counts[:2].max() <= 8192 < counts[2:4].max() <= 16384 \
        < counts[4:6].max()
    restarts = [s for s in spans if s.name == "scan.mv_restart"]
    assert [s.value for s in restarts] == [4, 6]
    assert all(s.end_ns >= s.start_ns for s in restarts)
    caps = [(s.name, s.value) for s in spans
            if s.name.startswith("scan.mv_capacity.")]
    assert caps == [("scan.mv_capacity.16384", 16384),
                    ("scan.mv_capacity.32768", 32768)]
    decoded = sum(s.value for s in spans if s.name == "scan.decode")
    assert decoded == len(counts) + 4 + 6


def test_live_row_spans_sit_in_the_stage_and_sum_the_counts(b_spans):
    fx, spans = b_spans
    rows = [s for s in spans if s.name == "detector.mv_rows"]
    assert rows and all(spans[s.parent].name == "detector.stage"
                        for s in rows)
    assert sum(s.value for s in rows) == int(fx.arrays["mv_counts"].sum())
    warm = [s for s in rows
            if spans[spans[s.parent].parent].name == "scan.warmup"]
    assert len(warm) == 1 and warm[0].value == 0
    # no other payload records live rows
    assert len(rows) == sum(1 for s in spans if s.name == "detector.stage")


def as_run(spans, ops=(), geom=None) -> Run:
    t0 = min(s.start_ns for s in spans)
    t1 = max(s.end_ns for s in spans)
    run = Run(geom=geom, t0_ns=t0, t1_ns=t1, setup_s=1.0, setup_parts={},
              cpu_s=1.0, files=[], specs={}, phases={}, spans=[],
              ops=list(ops))
    run.program_spans = [ProgramSpan(s.name, s.start_ns, s.end_ns,
                                     s.cpu_ns, s.thread, s.parent, s.file,
                                     s.value, s.launches) for s in spans]
    return run


def test_readers_on_the_recorded_spans(b_spans):
    fx, spans = b_spans
    counts = fx.arrays["mv_counts"]
    knobs = fx.meta["knobs"]
    geom = rule.Geometry(1920, 1080, 16, knobs["gw"], knobs["gh"],
                         knobs["y_min"], knobs["y_max"])
    t = min(s.start_ns for s in spans)
    busy_ns = 50_000
    ops = [trace.DeviceOp("void mv_cluster_kernel(short4 const*)", t,
                          t + busy_ns, "kernel", 0),
           trace.DeviceOp("Memcpy HtoD (Pinned -> Device)", t, t + 10_000,
                          "memcpy_htod", 40_000_000)]
    run = as_run(spans, ops, geom)
    read = {name: spec.metric_reader(name)(run) for name in READERS}
    staged = sum(s.value for s in spans if s.name == "detector.stage")
    frames = sum(s.value for s in spans if s.name == "detector.enqueue"
                 and spans[s.parent].name != "scan.warmup")
    assert frames == len(counts)
    rows = int(counts.sum())
    assert read["mv_payload_fill_pct"] == pytest.approx(
        100 * 8 * rows / staged)
    assert read["mv_redecode_pct"] == pytest.approx(100 * 10 / (88 + 10))
    centre = (knobs["y_max"] - knobs["y_min"]) * (knobs["gw"] - 2)
    least = max((8 * rows + 9 * frames) / 3.35e12,
                (12 * rows + 8 * centre * frames) / 67e12)
    assert read["k45_roofline_pct"] == pytest.approx(
        100 * least / (busy_ns / 1e9))
    assert roofline_mv.centre_cells(geom) == centre
    assert read["h2d_gbps"] == pytest.approx(4000.0)
    assert 0 < read["mv_payload_fill_pct"] < 100


# --- (f) nothing to read ---

def test_readers_read_nothing_from_an_untraced_run():
    run = Run(geom=None, t0_ns=0, t1_ns=10, setup_s=1.0, setup_parts={},
              cpu_s=1.0, files=[], specs={}, phases={})
    for name in READERS:
        assert spec.metric_reader(name)(run) is None, name


def test_readers_read_nothing_without_the_raw_mv_spans():
    """A traced run of another payload: decode spans, a K1 kernel, no
    restart and no live rows."""
    span = timing.Span
    spans = [span("scan.decode", 1_000, 2_000, 900, 1, "decode-0", -1, 1,
                  750, 0),
             span("detector.stage", 2_000, 3_000, 900, 2, "stream-0", -1,
                  1, 765_000, 0),
             span("detector.enqueue", 3_000, 4_000, 900, 2, "stream-0",
                  -1, 1, 750, 1)]
    k1 = trace.DeviceOp("word_cluster_kernel", 3_000, 3_500, "kernel", 0)
    run = as_run(spans, [k1])
    assert spec.metric_reader("k45_roofline_pct")(run) is None
    assert spec.metric_reader("mv_payload_fill_pct")(run) is None
    assert spec.metric_reader("h2d_gbps")(run) is None
    # the port has the restart's site, and this run restarted nothing
    assert spec.metric_reader("mv_redecode_pct")(run) == 0.0


def test_the_cell_is_in_the_benchmark_as_added():
    bench = spec.load_benchmark()
    cell = spec.cell(CELL, bench)
    assert cell.chips == 1 and cell.config["env"]["MVT_SCAN_INPUT"] == "mv_raw"
    assert cell.config["env"]["MVT_MV_CAPACITY"] == 8192
    assert {m["name"] for m in cell.end_to_end} == {"video_s_per_s",
                                                    "setup_s"}
    layers = {m["name"]: m for m in cell.per_layer}
    assert set(READERS) <= set(layers)
    assert all(layers[n]["moves"] == "video_s_per_s" for n in READERS)
    entry, = [c for c in bench["configs"]
              if c["name"] == "cctv1080_h264_mvraw"]
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
