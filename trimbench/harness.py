"""One run of one cell: set-up, the measured window, the check, the
metrics.

The window drives the program's directory batch,
``mvtrim_tpu_torch.batch.batch.BatchProcessor.process``, over the cell's
backlog: its stream workers run ``ProcessingPipeline.run`` a file and
hand each cut to the shared ``CutQueue``.  Decode is the stand-in's
(``standin.Decoder`` at the ``native.VideoReader`` seam) and the remux is
``standin.Remux`` at the external cut; both lie outside what is
measured.  When the window
closes the harness calls ``BatchProcessor.abort()``: the workers finish
the file in flight (checked, not counted) and the cut queue drains.

The program's log lines go to a file under ``TMPDIR``, with its inputs'
placeholders and its metrics lines; the whole run directory goes when
the run ends.  Its kernel library and every compiler
cache stay in ``build/trimbench/`` of the checkout, so only a checkout's
first run builds.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import resource
import shutil
import sys
import tempfile
import threading
import time

from . import backlog, check, probes, scene, spec, standin
from . import trace as device_trace
from .record import Run
from .reference import rule

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mvtrim_tpu")


def cache_env(root: str = spec.ROOT) -> dict:
    base = os.path.join(root, "build", "trimbench")
    return {"MVT_COMPILE_CACHE": os.path.join(base, "kernels"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda"),
            "USE_FLAX": "0"}


def knob_env(knobs: dict) -> dict:
    return {k: str(v) for k, v in knobs.items()}


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is a JAX one or the JAX
    package's, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


@contextlib.contextmanager
def stdout_to(path: str):
    """Send what the process writes to fd 1 into ``path``."""
    sys.stdout.flush()
    saved = os.dup(1)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    os.dup2(fd, 1)
    os.close(fd)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _torch_threads(n: int | None = None) -> int | None:
    """torch's intra-op thread count, set to ``n`` where given; None
    where torch is not loaded yet."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    if n is not None:
        torch.set_num_threads(n)
    return torch.get_num_threads()


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _metrics_lines(path: str) -> dict:
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                out[rec["input"]] = rec
    return out


def _tail(path: str, lines: int = 20) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-lines:])


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
             t_start: float, require_cuda: bool = True,
             env: dict | None = None) -> dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced,
    ``setup_parts``, ``checks``)."""
    saved_env = dict(os.environ)
    saved_threads = _torch_threads()
    workdir = tempfile.mkdtemp(prefix=f"trimbench-{cell.name}-")
    try:
        with stdout_to(os.path.join(workdir, "program.log")):
            result = _run(cell, seed, seconds, trace, t_start, require_cuda,
                          env or {}, workdir)
        if not result["correct"]:
            print(f"program log, last lines:\n"
                  f"{_tail(os.path.join(workdir, 'program.log'))}",
                  file=sys.stderr)
        return result
    finally:
        os.environ.clear()
        os.environ.update(saved_env)
        _torch_threads(saved_threads)
        shutil.rmtree(workdir, ignore_errors=True)


def _run(cell, seed, seconds, trace, t_start, cuda, env, workdir):
    parts = {}
    lap = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - lap[0]
        lap[0] = now

    camera = cell.config["camera"]
    knobs = {**cell.config["env"], **env}
    os.environ.update(knob_env(knobs))
    os.environ.update(cache_env())
    os.environ.update(MVT_FFMPEG_BIN=standin.FFMPEG_BIN,
                      MVT_METRICS_JSON=os.path.join(workdir, "metrics.jsonl"))

    import torch
    from mvtrim_tpu_torch.batch.batch import BatchProcessor
    from mvtrim_tpu_torch.core.config import Config
    if "OMP_NUM_THREADS" in knobs:
        # the command sets it before torch loads; a run inside another
        # process (the CPU tests) sets it here
        torch.set_num_threads(int(knobs["OMP_NUM_THREADS"]))
    parts["import_s"] = time.perf_counter() - t_start
    lap[0] = time.perf_counter()
    if cuda:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    mark("cuda_s")
    if cuda:
        from mvtrim_tpu_torch.ops import _build
        _build.load_library()
    mark("library_s")

    geom = rule.Geometry.of(camera["width"], camera["height"], knobs)
    scenes = {name: scene.build(name, camera, params, geom, seed)
              for name, params in cell.config["scene"].items()}
    specs = backlog.generate(cell.traffic, camera["fps"], seed,
                             os.path.join(workdir, "in"))
    warm = backlog.warm(cell.traffic, camera["fps"],
                        os.path.join(workdir, "in"))
    decoder = standin.Decoder(camera, scenes, specs + warm)
    remux = standin.Remux()
    undo_standins = standin.install(decoder, remux)
    mark("pools_s")

    streams = int(knobs["PARALLEL_STREAMS"])
    try:
        BatchProcessor(streams, Config.from_env()).process(
            [w.name for w in warm], os.path.join(workdir, "warm_out"))
        mark("warm_s")

        recorder = probes.Recorder(trace)
        decoder.recorder = recorder
        undo_probes = probes.install(recorder)
        try:
            processor = BatchProcessor(streams, Config.from_env())
            profiler = (device_trace.Profiler(
                os.path.join(workdir, "trace.json")) if trace else None)
            if profiler:
                profiler.start()
            # the set-up's objects (imports, pools, the backlog's specs)
            # leave the collector's generations, so that a full collection
            # in the window scans only what the window made
            gc.collect()
            gc.freeze()
            batch = threading.Thread(
                target=processor.process,
                args=([s.name for s in specs], os.path.join(workdir, "out")),
                name="trimbench-batch")
            cpu0 = _cpu_s()
            t0 = time.time_ns()
            setup_s = time.perf_counter() - t_start
            batch.start()
            batch.join(timeout=seconds)
            processor.abort()
            t1 = time.time_ns()
            cpu_s = _cpu_s() - cpu0
            ops = profiler.stop() if profiler else None
            batch.join(timeout=300)
            if batch.is_alive():
                raise RuntimeError("the batch did not end within 300 s of "
                                   "the window's close")
            memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        finally:
            gc.unfreeze()
            undo_probes()
    finally:
        undo_standins()

    by_path = {s.name: s for s in specs}
    files = recorder.files
    lists = {s.name: remux.lists[os.path.basename(s.name)]
             for s in specs if os.path.basename(s.name) in remux.lists}
    reference = check.Reference(knobs, scenes, geom)
    t_check = time.perf_counter()
    numbers, faults = check.compare(files, by_path, lists, reference)
    check_s = time.perf_counter() - t_check
    correct = check.passes(numbers)

    run = Run(geom=geom, t0_ns=t0, t1_ns=t1, setup_s=setup_s,
              setup_parts=parts, cpu_s=cpu_s, files=files, specs=by_path,
              phases=_metrics_lines(os.environ["MVT_METRICS_JSON"]),
              spans=recorder.spans if trace else None,
              ops=device_trace.clipped(ops, t0, t1) if ops is not None
              else None)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": len(files),
              "failed": numbers["files_failed"], "metrics": metrics,
              "device": device}
    if run.ops is not None:
        device["busy_s"] = device_trace.busy_ns(run.ops) / 1e9
        device["window_s"] = run.window_s
        top = sorted(device_trace.by_name(run.ops).items(),
                     key=lambda kv: kv[1], reverse=True)[:10]
        result["breakdown"] = {
            "device_ops": [[name[:120], s] for name, s in top],
            "idle_gaps": device_trace.label_gaps(
                device_trace.idle_gaps(run.ops, t0, t1),
                [s for s in run.spans if s[2] > t0 and s[1] < t1])}
    result["setup_parts"] = dict(parts, check_s=check_s,
                                 files_counted=len(run.counted()),
                                 video_s_counted=run.video_s())
    result["faults"] = faults
    result["checks"] = {
        name: {"value": numbers[name], side: limit}
        for name, (side, limit) in check.LIMITS.items()}
    return result
