"""The metric readers on a recorded run: files, the program's phases, the
benchmark's spans and the card's operations, all made up by hand."""

from __future__ import annotations

import pytest

from trimbench import roofline, spec, trace
from trimbench.probes import FileRecord
from trimbench.record import Run
from trimbench.reference import rule
from trimbench.scene import FileSpec

MS = 1_000_000
KNOBS = {"BLOCK_SIZE": 16, "VERTICAL_MASK": 0.05}
GEOM = rule.Geometry.of(1920, 1080, KNOBS)
K1 = "void (anonymous namespace)::word_cluster_kernel<true, false>(x)"
K6 = "void (anonymous namespace)::sad_block_kernel<16>(x)"


def recorded(traced: bool = True) -> Run:
    specs = {f"/in/{k}.mp4": FileSpec(f"/in/{k}.mp4", 1500, 25.0, ())
             for k in "abcd"}
    files = [FileRecord("/in/a.mp4", 0, 400 * MS, 0),
             FileRecord("/in/b.mp4", 100 * MS, 900 * MS, 0),
             FileRecord("/in/c.mp4", 200 * MS, 1000 * MS, 0),
             FileRecord("/in/d.mp4", 900 * MS, 1500 * MS, 0)]  # in flight
    phases = {
        "/in/a.mp4": {"phases_us": {"parallel_scan[mv]": 300_000,
                                    "total_run": 390_000}},
        "/in/b.mp4": {"phases_us": {"parallel_scan[mv]": 100_000,
                                    "parallel_scan[sad]": 600_000,
                                    "total_run": 790_000}},
    }
    spans = [("dispatch:bits", 10 * MS, 11 * MS, 750),
             ("resolve", 12 * MS, 13 * MS, 0),
             ("dispatch:bits", 20 * MS, 22 * MS, 250),
             ("scan_luma", 30 * MS, 40 * MS, 129),
             ("standin_scan", 50 * MS, 450 * MS, 0),
             ("dispatch:bits", 1100 * MS, 1101 * MS, 9)]  # after the window
    ops = [trace.DeviceOp(K1, 11 * MS, 11 * MS + 4000, "kernel", 0),
           trace.DeviceOp("Memcpy HtoD (Pinned -> Device)", 10 * MS,
                          10 * MS + 40_000, "memcpy_htod", 2_000_000),
           trace.DeviceOp(K6, 31 * MS, 31 * MS + 100_000, "kernel", 0),
           trace.DeviceOp(K6, 32 * MS, 32 * MS + 100_000, "kernel", 0),
           trace.DeviceOp(K6, 33 * MS, 33 * MS + 100_000, "kernel", 0)]
    return Run(geom=GEOM, t0_ns=0, t1_ns=1000 * MS, setup_s=9.5, setup_parts={},
               cpu_s=1.5, files=files, specs=specs, phases=phases,
               spans=spans if traced else None, ops=ops if traced else None)


def read(name, run):
    return spec.metric_reader(name)(run)


def test_end_to_end_readers():
    run = recorded(traced=False)
    assert read("video_s_per_s", run) == pytest.approx(180.0 / 1.0)
    assert read("cpu_s_per_video_h", run) == pytest.approx(1.5 / (180 / 3600))
    assert read("host_cpu_s_per_video_h", run) == read("cpu_s_per_video_h", run)
    assert read("file_p95_ms", run) == pytest.approx(800.0)
    assert read("setup_s", run) == 9.5


def test_phase_readers():
    run = recorded()
    assert read("scan_ms_per_video_min", run) == pytest.approx(
        1000.0 / (120 / 60))
    assert read("file_overhead_ms", run) == pytest.approx((90 + 90) / 2)


def test_span_and_trace_readers():
    run = recorded()
    assert read("dispatch_host_us", run) == pytest.approx(
        (1 + 1 + 2) * 1000 / 2)
    assert read("scan_luma_host_ms", run) == pytest.approx(10.0)
    assert read("batch_start_ms", run) == pytest.approx(0.0)
    run.files = run.files[1:]
    assert read("batch_start_ms", run) == pytest.approx(100.0)
    assert read("h2d_gbps", run) == pytest.approx(2_000_000 / 40_000)
    k1 = roofline.least_s(1000 * roofline.k1_bytes_per_frame(GEOM),
                          1000 * roofline.k1_ops_per_frame(GEOM))
    assert read("k1_roofline_pct", run) == pytest.approx(100 * k1 / 4e-6)
    k6 = roofline.least_s(roofline.k6_bytes(GEOM, 129, 3),
                          roofline.k6_ops(GEOM, 129))
    assert read("k6_roofline_pct", run) == pytest.approx(100 * k6 / 300e-6)
    busy = 4000 + 40_000 + 3 * 100_000
    assert read("device_idle_pct", run) == pytest.approx(
        100 * (1 - busy / (1000 * MS)))


def test_readers_find_nothing_to_read_without_a_trace():
    run = recorded(traced=False)
    for name in ("dispatch_host_us", "scan_luma_host_ms", "h2d_gbps", "k1_roofline_pct",
                 "k6_roofline_pct", "device_idle_pct"):
        assert read(name, run) is None, name
    run.files = []
    for name in ("video_s_per_s", "cpu_s_per_video_h", "host_cpu_s_per_video_h",
                 "file_p95_ms",
                 "scan_ms_per_video_min", "file_overhead_ms",
                 "batch_start_ms"):
        assert read(name, run) is None, name


def test_trace_reduction():
    ops = recorded().ops
    gaps = trace.idle_gaps(ops, 0, 1000 * MS)
    assert gaps[0] == (0, 10 * MS)
    assert sum(b - a for a, b in gaps) + trace.busy_ns(ops) == 1000 * MS
    labelled = trace.label_gaps(gaps, recorded().spans, count=2)
    assert labelled[0][0] == "standin_scan"
    assert trace.kind_of("Memcpy DtoH (Device -> Pinned)") == "memcpy_dtoh"
    assert trace.by_name(ops)[K6] == pytest.approx(300e-6)
    clipped = trace.clipped(ops, 32 * MS + 50_000, 1000 * MS)
    assert [op.start_ns for op in clipped][0] == 32 * MS + 50_000


def test_exported_trace_gives_device_ops_and_bytes():
    doc = {"baseTimeNanoseconds": 1_000_000_000,
           "traceEvents": [
               {"ph": "X", "cat": "gpu_memcpy", "ts": 10.5, "dur": 2.0,
                "name": "Memcpy HtoD (Pinned -> Device)",
                "args": {"bytes": 4096}},
               {"ph": "X", "cat": "cuda_runtime", "ts": 10.0, "dur": 1.0,
                "name": "cudaMemcpyAsync", "args": {}},
               {"ph": "X", "cat": "kernel", "ts": 13.0, "dur": 3.25,
                "name": K1, "args": {}},
               {"ph": "X", "cat": "gpu_memset", "ts": 20.0, "dur": 1.0,
                "name": "Memset (Device)", "args": {}}]}
    ops = trace.from_chrome(doc)
    assert [(op.kind, op.start_ns, op.end_ns, op.nbytes) for op in ops] == [
        ("memcpy_htod", 1_000_010_500, 1_000_012_500, 4096),
        ("kernel", 1_000_013_000, 1_000_016_250, 0),
        ("memset", 1_000_020_000, 1_000_021_000, 0)]
