"""The program's spans (``utils.timing.SPANS``) on the CPU build.

With recording off a run and a batch leave nothing; with it on they
leave the layer-boundary spans with their parents, one file id a run
(shared by its decode workers and the cut worker), starts on
``time.time_ns()`` and CPU time within wall time.  In batch mode the
metrics line holds the scan's sub-phases, and ``MVT_PROFILE_DIR`` holds
one trace a batch with the spans on the trace's time base.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

from mvtrim_tpu_torch.batch.batch import BatchProcessor
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.core.types import GridGeometry
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.models import staging
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.ops import cluster as cluster_ops
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.utils import timing
from mvtrim_tpu_torch.utils.timing import SPANS, TimingCollector

from torch_staging_fakes import DEVICE, FakeCard

TORCH = Config(scan_backend="torch")
SCAN = {"pipeline.probe", "scan.warmup", "scan.setup", "scan.join",
        "scan.feeder_wait", "scan.decode", "detector.stage",
        "detector.enqueue", "pipeline.segment"}
BATCH = {"batch.enqueue", "batch.file", "batch.next_file", "cut.wait",
         "cut.run"}


@pytest.fixture(scope="module")
def motion_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "motion.mp4")
    native.synthesize(path, width=640, height=480, fps=25.0, duration=20.0,
                      codec="libx264",
                      motion_windows=((2.0, 5.0), (12.0, 14.0)))
    return path


@pytest.fixture(scope="module")
def static_clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "static.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=6.0,
                      codec="libx264", motion_windows=())
    return path


@pytest.fixture(autouse=True)
def recording_off():
    timing.stop_recording()
    TimingCollector.clear()
    yield
    timing.stop_recording()
    TimingCollector.clear()


def batch_inputs(tmp_path, motion_clip, static_clip):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for name, clip in (("a.mp4", motion_clip), ("b.mp4", static_clip),
                       ("c.mp4", motion_clip)):
        os.symlink(clip, in_dir / name)
    return sorted(str(p) for p in in_dir.iterdir())


def recorded(fn):
    t0 = timing.time.time_ns()
    assert timing.start_recording()
    fn()
    spans = timing.stop_recording()
    return spans, t0, timing.time.time_ns()


def check_clocks(spans, t0, t1):
    for s in spans:
        assert t0 <= s.start_ns <= s.end_ns <= t1, s
        assert 0 <= s.cpu_ns <= s.end_ns - s.start_ns, s


def test_off_leaves_no_spans_and_no_buffers(motion_clip, static_clip,
                                            tmp_path):
    assert not SPANS.on
    assert ProcessingPipeline(motion_clip, str(tmp_path / "o.mp4"),
                              cfg=TORCH).run() == 0
    files = batch_inputs(tmp_path, motion_clip, static_clip)
    assert BatchProcessor(2, TORCH).process(files, str(tmp_path / "out")) == 0
    assert SPANS.recorded() == []
    assert SPANS._bufs == [] and len(SPANS._tids) == 0


def test_single_run_spans(motion_clip, tmp_path):
    metrics = tmp_path / "m.jsonl"
    cfg = Config(scan_backend="torch", metrics_json=str(metrics))
    spans, t0, t1 = recorded(lambda: ProcessingPipeline(
        motion_clip, str(tmp_path / "o.mp4"), cfg=cfg).run())
    rec = json.loads(metrics.read_text())
    names = collections.Counter(s.name for s in spans)
    assert set(names) == SCAN  # no detector.wait: nothing waits on the CPU
    for name in ("pipeline.probe", "scan.warmup", "scan.setup", "scan.join",
                 "pipeline.segment"):
        assert names[name] == 1, name
    check_clocks(spans, t0, t1)
    assert len({s.file for s in spans}) == 1 and spans[0].file > 0
    assert {s.thread for s in spans if s.name == "scan.decode"} == \
        {"decode-0"}
    assert {s.thread for s in spans if s.name != "scan.decode"} == \
        {"MainThread"}

    warmup = [i for i, s in enumerate(spans) if s.name == "scan.warmup"]
    under_warmup = [s for s in spans if s.parent in warmup]
    assert sorted(s.name for s in under_warmup) == \
        ["detector.enqueue", "detector.stage"]
    assert [s.value for s in under_warmup
            if s.name == "detector.enqueue"] == [1]
    chunks = [s for s in spans if s.name == "detector.enqueue"
              and s.parent not in warmup]
    assert all(s.parent == -1 for s in chunks)
    frames = rec["frames_scanned"]
    assert sum(s.value for s in chunks) == frames
    assert sum(s.value for s in spans if s.name == "scan.decode") == frames
    geom = GridGeometry.build(640, 480, cfg)
    row_bytes = geom.gh * ((geom.gw + 7) // 8)
    assert sum(s.value for s in spans if s.name == "detector.stage") == \
        (frames + 1) * row_bytes
    assert [s.value for s in spans if s.name == "pipeline.segment"] == \
        [rec["motion_frames"]]
    assert all(s.launches == 0 for s in spans)  # the CPU build launches none


def test_batch_spans_share_a_file_id(motion_clip, static_clip, tmp_path):
    files = batch_inputs(tmp_path, motion_clip, static_clip)
    spans, t0, t1 = recorded(lambda: BatchProcessor(2, TORCH).process(
        files, str(tmp_path / "out")))
    check_clocks(spans, t0, t1)
    names = collections.Counter(s.name for s in spans)
    assert set(names) == SCAN | BATCH
    enqueue, = [s for s in spans if s.name == "batch.enqueue"]
    assert enqueue.value == 3 and enqueue.parent == -1

    probes = [s for s in spans if s.name == "pipeline.probe"]
    assert len(probes) == 3
    run_files = {s.file for s in probes}
    assert len(run_files) == 3 and 0 not in run_files
    for s in spans:
        if s.name in ("pipeline.probe", "batch.next_file"):
            assert spans[s.parent].name == "batch.file", s
        if s.name == "batch.file":
            assert s.thread.startswith("stream-") and s.parent == -1
            assert s.value == int(s.thread.split("-")[1])
    for name in ("scan.decode", "cut.wait", "cut.run"):
        assert {s.file for s in spans if s.name == name} <= run_files, name
    # both motion clips are cut, by the cut worker, for their own runs
    cuts = [s for s in spans if s.name == "cut.run"]
    assert len(cuts) == 2 and {s.thread for s in cuts} == {"cut-worker"}
    waits = [s for s in spans if s.name == "cut.wait"]
    assert sorted(s.file for s in waits) == sorted(s.file for s in cuts)
    assert all(s.value >= 1 and s.cpu_ns == 0 for s in waits)
    for f in run_files:
        threads = {s.thread for s in spans if s.file == f}
        assert any(t.startswith("stream-") for t in threads)
        assert any(t.startswith("decode-") for t in threads)


def test_batch_records_the_scan_sub_phases(motion_clip, static_clip,
                                           tmp_path):
    metrics = tmp_path / "m.jsonl"
    files = batch_inputs(tmp_path, motion_clip, static_clip)
    cfg = Config(scan_backend="torch", metrics_json=str(metrics))
    assert BatchProcessor(2, cfg).process(files, str(tmp_path / "out")) == 0
    lines = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert len(lines) == 3
    for rec in lines:
        phases = rec["phases_us"]
        for name in ("parallel_scan[mv]", "  ├─warmup(build)", "  ├─setup",
                     "  ├─dispatch", "  ├─resolve", "  └─join"):
            assert name in phases, name
        assert not any("device_scan" in name for name in phases)


def test_profile_dir_holds_one_trace_a_batch(motion_clip, static_clip,
                                             tmp_path):
    prof = tmp_path / "prof"
    files = batch_inputs(tmp_path, motion_clip, static_clip)
    cfg = Config(scan_backend="torch", profile_dir=str(prof))
    t0 = timing.time.time_ns()
    assert BatchProcessor(2, cfg).process(files, str(tmp_path / "out")) == 0
    t1 = timing.time.time_ns()
    assert not SPANS.on
    traces = os.listdir(prof)
    assert len(traces) == 1
    doc = json.loads((prof / traces[0]).read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "mvtrim"]
    assert {e["name"] for e in ours} == SCAN | BATCH
    for e in ours:
        start = base + e["ts"] * 1e3
        assert t0 - 1e3 <= start <= start + e["dur"] * 1e3 <= t1 + 1e3, e
    named = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "thread_name"
             and e["args"]["name"].startswith(("stream-", "decode-"))}
    assert {e["tid"] for e in ours if e["name"] == "batch.file"} <= \
        set(named)


def test_an_outside_profiler_turns_recording_on(motion_clip, static_clip,
                                                tmp_path):
    from torch.profiler import ProfilerActivity, profile

    files = batch_inputs(tmp_path, motion_clip, static_clip)
    with profile(activities=[ProfilerActivity.CPU]):
        assert BatchProcessor(2, TORCH).process(
            files, str(tmp_path / "out")) == 0
    assert not SPANS.on
    spans = timing.stop_recording()
    assert {s.name for s in spans} == SCAN | BATCH
    assert BatchProcessor(2, TORCH).process(files, str(tmp_path / "o2")) == 0
    assert timing.stop_recording() == []


def test_tokens_nest_and_go_stale():
    assert timing.start_recording() and not timing.start_recording()
    outer = SPANS.begin("outer")
    inner = SPANS.begin("inner")
    SPANS.end(outer, 7)  # closes the inner span left open
    SPANS.end(inner)
    stale = SPANS.begin("stale")
    timing.stop_recording()
    assert timing.start_recording()
    SPANS.end(stale)
    SPANS.end(SPANS.begin("fresh"), 1)
    spans = timing.stop_recording()
    assert [(s.name, s.parent, s.value) for s in spans] == [("fresh", -1, 1)]
    assert timing.start_recording()
    outer = SPANS.begin("outer")
    SPANS.end(SPANS.begin("inner"), 2)
    SPANS.end(outer, 7)
    assert [(s.name, s.parent, s.value) for s in timing.stop_recording()] \
        == [("outer", -1, 7), ("inner", 0, 2)]


def test_chrome_events_are_on_the_trace_time_base():
    span = timing.Span("detector.stage", 5_000_000_500, 5_000_002_500, 1500,
                       77, "stream-0", -1, 3, 4096, 0)
    event, meta = timing.chrome_events([span], 5_000_000_000, 9)
    assert (event["ts"], event["dur"], event["tid"], event["pid"]) == \
        (0.5, 2.0, 77, 9)
    assert event["args"] == {"file": 3, "value": 4096, "launches": 0,
                             "cpu_us": 1.5}
    assert meta["args"]["name"] == "stream-0"


def check_pins(spans, pool, batches):
    """A ``detector.pin`` span a new slot, inside its ``detector.stage``,
    valued at the host bytes pinned; one launch and one wait a batch."""
    pins = [s for s in spans if s.name == "detector.pin"]
    assert len(pins) == pool.slots
    assert all(spans[s.parent].name == "detector.stage" for s in pins)
    assert sum(s.value for s in pins) == pool.pinned_bytes
    enqueues = [s for s in spans if s.name == "detector.enqueue"]
    assert [s.launches for s in enqueues] == [1] * batches
    assert len([s for s in spans if s.name == "detector.stage"]) == batches
    assert len([s for s in spans if s.name == "detector.wait"]) == batches
    return enqueues


def test_pin_once_a_new_slot_never_once_a_batch(monkeypatch):
    """The detector's card path on a stand-in card (CPU): the first scan
    pins a slot a batch in flight, the next ones reuse them."""
    cfg = Config(scan_backend="torch", device_batch=64)
    det = MVClusterDetector(1920, 1080, cfg)
    card = FakeCard(det.geom)
    pool = card.install(monkeypatch)
    det.device = DEVICE
    g = det.geom
    rng = np.random.default_rng(3)
    chunks = [rng.integers(0, 256, (n, g.gh, (g.gw + 7) // 8),
                           dtype=np.uint8) for n in (150, 150, 40, 128)]
    spans, _, _ = recorded(lambda: [det.scan_bits_async(c)()
                                    for c in chunks])
    enqueues = check_pins(spans, pool, 3 + 3 + 1 + 2)
    assert pool.slots == 3 and pool.free() == 3
    assert [s.value for s in enqueues] == [64, 64, 22] * 2 + [40, 64, 64]
    # frames_per_launch: every frame over one launch a batch
    assert sum(s.value for s in enqueues) / sum(
        s.launches for s in enqueues) == 468 / 9


@pytest.mark.cuda
def test_cuda_enqueue_counts_the_op_launches(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(staging, "_pools", {})
    cfg = Config(scan_backend="auto", device_batch=64)
    det = MVClusterDetector(1920, 1080, cfg)
    g = det.geom
    bits = np.random.default_rng(3).integers(
        0, 256, (150, g.gh, (g.gw + 7) // 8), dtype=np.uint8)
    before = cluster_ops.cluster_words_op.launches
    assert timing.start_recording()
    motion = det.scan_bits_async(bits)()
    again = det.scan_bits_async(bits)()
    spans = timing.stop_recording()
    launched = cluster_ops.cluster_words_op.launches - before
    enqueues = check_pins(spans, staging.pool_for(det.device), 6)
    assert [s.value for s in enqueues] == [64, 64, 22] * 2
    assert sum(s.launches for s in enqueues) == launched == 6
    assert len([s for s in spans if s.name == "detector.pin"]) == 3
    assert motion.shape == (150,)
    np.testing.assert_array_equal(again, motion)
