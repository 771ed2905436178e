"""Host/device topology discovery.

The reference detects container CPU limits through cgroup v2/v1 and pins
threads to cpusets (system.cpp:107-225).  In the rebuild, thread *pinning*
is gone (decode threads are OS-scheduled; analysis runs on the device),
but the CPU *limit* still governs how many decode workers to spawn.
The copy in ``mvtrim_tpu_torch`` keeps the host half of
``mvtrim_tpu/utils/system.py``; the device queries there are JAX's.
"""

from __future__ import annotations

import os

MAX_DETECTED_CPUS = 64  # same safety cap as the reference (system.cpp:104)


def _read_first_line(path: str) -> str | None:
    try:
        with open(path) as f:
            return f.readline().strip()
    except OSError:
        return None


def parse_cpuset_list(spec: str) -> list[int]:
    """Expand a cpuset list like '0-3,8,10-11' into sorted CPU ids
    (same grammar the reference parses, system.cpp:49-80, and that
    `taskset -c` accepts)."""
    cpus: set[int] = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            cpus.update(range(int(lo), int(hi) + 1))
        else:
            cpus.add(int(part))
    return sorted(cpus)


def _parse_cpuset(spec: str) -> int:
    """Count CPUs in a cpuset list (system.cpp:49-80)."""
    return len(parse_cpuset_list(spec))


def detect_cpu_limit() -> int:
    """cgroup-aware CPU limit (reference detect_cpu_limit, system.cpp:107-158).

    Order: cgroup v2 cpu.max quota; cgroup v1 cfs_quota/cfs_period;
    cpuset (v2 then v1); finally os.cpu_count().  Result in [1, 64].
    """
    limit = 0

    # cgroup v2: "<quota|max> <period>"
    line = _read_first_line("/sys/fs/cgroup/cpu.max")
    if line:
        parts = line.split()
        if len(parts) == 2 and parts[0] != "max":
            quota, period = int(parts[0]), int(parts[1])
            if period > 0:
                limit = max(1, quota // period)

    # cgroup v1: cfs_quota_us / cfs_period_us
    if limit == 0:
        quota_s = _read_first_line("/sys/fs/cgroup/cpu/cpu.cfs_quota_us")
        period_s = _read_first_line("/sys/fs/cgroup/cpu/cpu.cfs_period_us")
        if quota_s and period_s:
            quota, period = int(quota_s), int(period_s)
            if quota > 0 and period > 0:
                limit = max(1, quota // period)

    # cpuset restriction
    if limit == 0:
        for path in ("/sys/fs/cgroup/cpuset.cpus.effective",
                     "/sys/fs/cgroup/cpuset/cpuset.cpus"):
            spec = _read_first_line(path)
            if spec:
                n = _parse_cpuset(spec)
                if n > 0:
                    limit = n
                    break

    if limit == 0:
        limit = os.cpu_count() or 1
    return max(1, min(limit, MAX_DETECTED_CPUS))


def available_cpus() -> int:
    """Usable CPU count respecting the scheduler affinity mask
    (reference get_available_cpus, system.cpp:166-183)."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:
        return max(1, os.cpu_count() or 1)


def calculate_parallel_streams(threads_per_stream: int = 0) -> int:
    """Auto stream count (reference calculate_parallel_streams,
    system.cpp:186-197 — the documented reserved CPU does not exist in the
    implementation; we follow the implementation)."""
    cpus = min(detect_cpu_limit(), available_cpus())
    tps = threads_per_stream if threads_per_stream > 0 else 2
    return max(1, cpus // tps)


def rss_mb() -> float:
    """This process's resident set size in MB (0.0 if unreadable)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return 0.0
