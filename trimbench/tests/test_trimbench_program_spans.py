"""The readers of the program's own spans (``program.py`` and the seven
``metrics/`` that read it), on spans made up by hand, and one traced CPU
run in which the program records them under the profiler's session."""

from __future__ import annotations

import time

import pytest

from trimbench import harness, program, spec, trace
from trimbench.program import ProgramSpan
from trimbench.record import Run

from trimbench_cases import CPU_ENV, small_cell

MS = 1_000_000
K1 = "void (anonymous namespace)::word_cluster_kernel<true, false>(x)"
NEW = ("batch_enqueue_ms", "host_offcpu_pct", "scan_fixed_ms", "stage_us",
       "enqueue_us", "resolve_wait_us", "frames_per_launch")


def span(name, start_ms, end_ms, cpu_ms=0.0, parent=-1, value=0,
         launches=0, thread="stream-0", file=1):
    return ProgramSpan(name, int(start_ms * MS), int(end_ms * MS),
                       int(cpu_ms * MS), thread, parent, file, value,
                       launches)


def traced_run(spans) -> Run:
    ops = [trace.DeviceOp(K1, 30 * MS, 30 * MS + 4000, "kernel", 0),
           trace.DeviceOp(K1, 60 * MS, 60 * MS + 4000, "kernel", 0)]
    run = Run(geom=None, t0_ns=0, t1_ns=1000 * MS, setup_s=1.0,
              setup_parts={}, cpu_s=1.0, files=[], specs={}, phases={},
              spans=[], ops=ops)
    run.program_spans = spans
    return run


SPANS = [
    span("batch.enqueue", 0, 25, cpu_ms=20, value=3000),            # 0
    span("batch.file", 25, 200, cpu_ms=10, value=0),                 # 1
    span("pipeline.probe", 26, 28, cpu_ms=1, parent=1),              # 2
    span("scan.warmup", 28, 31, cpu_ms=2, parent=1),                 # 3
    span("detector.stage", 28, 28.5, cpu_ms=0.5, parent=3, value=150),
    span("detector.enqueue", 28.5, 29, cpu_ms=0.25, parent=3, value=1,
         launches=1),                                                # 5
    span("detector.wait", 29, 31, parent=3),                         # 6
    span("scan.setup", 31, 32, cpu_ms=1, parent=1),                  # 7
    span("scan.feeder_wait", 32, 50, parent=1),                      # 8
    span("detector.stage", 50, 51, cpu_ms=0.5, parent=1, value=112500),
    span("detector.enqueue", 51, 52, cpu_ms=0.5, parent=1, value=750,
         launches=1),                                                # 10
    span("detector.wait", 55, 57, parent=1),                         # 11
    span("scan.join", 57, 60, parent=1),                             # 12
    span("scan.decode", 33, 50, cpu_ms=9, thread="decode-0",
         value=750),                                                 # 13
    span("pipeline.segment", 60, 61, cpu_ms=1, parent=1, value=40),  # 14
    span("cut.wait", 61, 70, thread="cut-worker", value=2),          # 15
    span("cut.run", 70, 80, cpu_ms=5, thread="cut-worker", value=2),  # 16
    span("detector.enqueue", 1001, 1002, value=99, launches=5),  # after
]


def read(name, run):
    return spec.metric_reader(name)(run)


def test_readers_of_the_program_spans():
    run = traced_run(SPANS)
    assert read("batch_enqueue_ms", run) == pytest.approx(25.0)
    # probe, stage, enqueue, stage, enqueue, decode, segment, cut.run
    walls = [2, 0.5, 0.5, 1, 1, 17, 1, 10]
    cpus = [1, 0.5, 0.25, 0.5, 0.5, 9, 1, 5]
    assert read("host_offcpu_pct", run) == pytest.approx(
        100 * (sum(walls) - sum(cpus)) / sum(walls))
    assert read("scan_fixed_ms", run) == pytest.approx(3 + 1 + 3)
    assert read("stage_us", run) == pytest.approx((500 + 1000) / 2)
    assert read("enqueue_us", run) == pytest.approx((500 + 1000) / 2)
    assert read("resolve_wait_us", run) == pytest.approx((2000 + 2000) / 2)
    # the warm-up's frame is left out, its launch is not
    assert read("frames_per_launch", run) == pytest.approx(750 / 2)


def test_readers_find_nothing_without_program_spans():
    for spans in (None, []):
        run = traced_run(spans)
        for name in NEW:
            assert read(name, run) is None, name
    run = traced_run([s for s in SPANS if s.name != "detector.wait"])
    assert read("resolve_wait_us", run) is None
    run = traced_run([s._replace(launches=0) for s in SPANS])
    assert read("frames_per_launch", run) is None


def test_an_untraced_run_drains_nothing():
    run = traced_run(None)
    del run.program_spans
    run.ops = None
    assert program.spans(run) is None and run.program_spans is None


def test_idle_gaps_named_by_the_innermost_program_span():
    run = traced_run(SPANS)
    # after 60 ms the cut worker's spans; before 30 ms the enqueue (its
    # 25 ms over the leaves of batch.file); between, the feeder's wait
    assert [g[0] for g in program.idle_gaps(run, count=3)] == \
        ["cut.run", "batch.enqueue", "scan.feeder_wait"]
    assert program.idle_gaps(run, count=3)[1][1] == pytest.approx(0.030)
    leaves = {s.name for s in program.leaves(run)}
    assert "batch.file" not in leaves and "scan.warmup" not in leaves
    assert "detector.wait" in leaves
    assert [g[0] for g in program.idle_gaps(traced_run([]), 1)] == \
        ["no program span"]
    assert program.idle_gaps(traced_run(None)) is None


def test_a_traced_cpu_run_reads_the_program_spans(monkeypatch):
    """The window's batch records the program's spans under the
    profiler's session (CPU activity here: the CPU build traces no
    card), and the readers find them; the CPU build neither waits on an
    event nor launches a kernel."""
    from torch.profiler import ProfilerActivity, profile

    def cpu_profiler(self, path):
        self.path = path
        self.prof = profile(activities=[ProfilerActivity.CPU])

    monkeypatch.setattr(trace.Profiler, "__init__", cpu_profiler)
    result = harness.run_cell(small_cell("mv1080_events", 12), 20261018,
                              30.0, True, t_start=time.perf_counter(),
                              require_cuda=False, env=CPU_ENV)
    assert result["correct"]
    metrics = result["metrics"]
    for name in ("batch_enqueue_ms", "host_offcpu_pct", "scan_fixed_ms",
                 "stage_us", "enqueue_us", "dispatch_host_us"):
        assert name in metrics, name
    assert "resolve_wait_us" not in metrics
    assert "frames_per_launch" not in metrics
    assert 0 <= metrics["host_offcpu_pct"]["value"] <= 100
