"""Watch-daemon soak: feed files one at a time, check memory stays flat.

The counterpart of the JAX package's ``benchmarks/soak_watch.py``.  A
long-lived watch daemon (``WATCH_MODE=1`` under the compose service of
``mvtrim_tpu_torch/deploy/``) is how the system is deployed, and a slow
leak is its costliest failure.  On a card the daemon has leak surfaces of
its own: PyTorch's caching allocators, on the device and for pinned host
memory.

This drops ``--files`` clips, synthesized by the native library, into the
directory a ``python -m mvtrim_tpu_torch <in> <out>`` daemon watches, one
at a time; waits for each output; and samples the daemon's RSS and, where
it holds a card, its device memory as ``nvidia-smi`` reports it.  Healthy
is the JAX rule: every file processed, and growth from the third sample
on below 50 MB, in host RSS and in device memory.  Where the native
library (FFmpeg's libav*) does not load, it says so and exits 2: it never
reports a soak it did not run.

    python -m mvtrim_tpu_torch.bench.soak_watch [--files 10]

The daemon's backend follows MVT_SCAN_BACKEND (``auto``: the card).  The
last line of standard output is the result JSON; exit 0 when healthy.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GROWTH_LIMIT_MB = 50.0


def rss_mb(pid: int) -> float:
    """Resident set size of process ``pid`` in MB."""
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError(f"no VmRSS for process {pid}")


def device_mb(pid: int) -> float | None:
    """Device memory (MB) that ``nvidia-smi`` lists for process ``pid``,
    or None where there is no ``nvidia-smi`` or it lists no such
    process (it holds no card, or its PID is another namespace's)."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30).stdout
    used = [float(mb) for p, _, mb in
            (line.partition(",") for line in out.splitlines())
            if p.strip() == str(pid)]
    return sum(used) if used else None


def steady_growth(series: list[float]) -> float:
    """Growth from the third sample to the last (the first two absorb
    warm-up): 0.0 with fewer than four samples."""
    return series[-1] - series[2] if len(series) >= 4 else 0.0


def memory_healthy(series: dict[str, list]) -> bool:
    """Every series (None samples dropped) grows by less than
    ``GROWTH_LIMIT_MB`` from its third sample on."""
    return all(steady_growth([v for v in s if v is not None])
               < GROWTH_LIMIT_MB for s in series.values())


def _wait_for(path: str, timeout: float, proc) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return True
        if proc.poll() is not None:
            return False     # the daemon died: fail now, not at timeout
        time.sleep(0.1)
    return False


def soak(files: int, timeout_per_file: float) -> dict:
    """Run the soak; the result record.  Raises OSError where the native
    library does not load."""
    from ..io import native

    native._load_library()
    base = tempfile.mkdtemp(prefix="soak_")
    in_dir = os.path.join(base, "in")
    out_dir = os.path.join(base, "out")
    os.makedirs(in_dir)
    os.makedirs(out_dir)
    seed = os.path.join(base, "seed.mp4")
    native.synthesize(seed, width=640, height=480, fps=25.0, duration=10.0,
                      codec="libx264", motion_windows=((2.0, 5.0),))
    env = dict(os.environ, WATCH_MODE="1", MVT_LOG="0", PARALLEL_STREAMS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    daemon = subprocess.Popen(
        [sys.executable, "-m", "mvtrim_tpu_torch", in_dir, out_dir],
        env=env, cwd=base, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    samples = []
    try:
        for i in range(files):
            staging = os.path.join(base, f"f{i}.mp4")
            shutil.copy(seed, staging)
            t0 = time.monotonic()
            os.rename(staging, os.path.join(in_dir, f"f{i}.mp4"))
            # the first file absorbs the daemon's start and first use
            ok = _wait_for(os.path.join(out_dir, f"f{i}.mp4"),
                           timeout_per_file * (4 if i == 0 else 1), daemon)
            latency = time.monotonic() - t0
            alive = daemon.poll() is None
            samples.append({
                "file": i, "processed": ok, "latency_s": round(latency, 3),
                "rss_mb": round(rss_mb(daemon.pid), 1) if alive else None,
                "device_mb": device_mb(daemon.pid) if alive else None})
            print(f"file {i}: processed={ok} latency {latency:.3f} s "
                  f"rss={samples[-1]['rss_mb']} MB "
                  f"device={samples[-1]['device_mb']} MB", file=sys.stderr)
            if not ok:
                break
    finally:
        daemon.terminate()
        try:
            daemon.wait(timeout=30)
        except subprocess.TimeoutExpired:
            daemon.kill()
            daemon.wait()
        shutil.rmtree(base, ignore_errors=True)

    series = {"rss_mb": [s["rss_mb"] for s in samples],
              "device_mb": [s["device_mb"] for s in samples]}
    processed = sum(s["processed"] for s in samples)
    return {
        "files_processed": processed,
        "latency_s": [s["latency_s"] for s in samples],
        "rss_samples_mb": series["rss_mb"],
        "device_samples_mb": series["device_mb"],
        "steady_state_growth_mb": {
            k: round(steady_growth([v for v in s if v is not None]), 1)
            for k, s in series.items()},
        "healthy": processed == files and memory_healthy(series),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--files", type=int, default=10)
    ap.add_argument("--timeout-per-file", type=float, default=120.0)
    args = ap.parse_args(argv)
    try:
        result = soak(args.files, args.timeout_per_file)
    except OSError as e:
        print(f"soak_watch: the native library (libav) does not load, so "
              f"no clip can be made or decoded; nothing was soaked: {e}",
              file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0 if result["healthy"] else 1


if __name__ == "__main__":
    sys.exit(main())
