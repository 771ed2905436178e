"""The bench's audit: bytes and bounds, timing on the card, the checksum and
the roofline gate.

* **Bytes and bounds.**  ``least_time`` is the least time the card could
  take for a function: the larger of its bytes (each input read once, each
  output written once) over the HBM rate and its 32-bit integer operations
  over the peak rate.  ``rows_bytes``, ``map_bytes`` and ``word_bound``
  count the cluster kernels' bytes; ``chip_smoke.py`` reckons with the same
  functions.
* **Device time a launch.**  ``graph_time`` captures N launches over K
  rotated input buffers (K x the bytes a launch reads >= 100 MB, twice the
  H100's 50 MB L2) in one CUDA graph and times its replay between two
  events, with a sync before the read: the card's time, not the host's
  enqueue, which is several times a small kernel's (PERF.md).  Beside it,
  ``profiler_time`` reads torch.profiler's device time of eager launches,
  and ``host_time`` the host's µs a call.
* **Checksum.**  Every captured launch keeps its output in memory the
  graph owns; before each timed replay the outputs are overwritten, and
  after it they are summed in int64 and must equal the plain version's
  per-buffer sums weighted by the rotation (``expected_total``): a launch
  that did not run, or ran on the wrong buffer, fails it.
* **Roofline gate.**  A measurement whose implied rate exceeds 1.05 x the
  card's 3.35 TB/s, or whose checksum fails, is INVALID and yields no
  value (``gate``).

``Run`` carries what one bench run measures on: the device, the card's
name and power limit, and the depth.  On ``--device cpu`` the same code
times the plain versions with the host clock at tiny sizes, and every
number carries the label ``cpu-plain``.
"""

from __future__ import annotations

import dataclasses
import math
import subprocess
import time

import torch

from ..core.types import GridGeometry
from ..ops import cluster as cluster_ops

# the card's published peaks (NVIDIA's data sheet, H100 SXM): HBM bytes/s
# and the float32 CUDA-core rate, the table's nearest entry for the
# kernels' 32-bit integer operations (Hopper's int32 rate is lower, so the
# bound stays a lower bound)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
ROOFLINE_SLACK = 1.05
ROTATED_BYTES = 100e6   # twice the H100's 50 MB L2
CPU_LABEL = "cpu-plain"


def least_time(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def centre_cells(geom: GridGeometry) -> int:
    rows = min(geom.y_max, geom.gh) - max(geom.y_min, 0)
    return max(rows, 0) * max(geom.gw - 2, 0)


def rows_bytes(geom: GridGeometry, b: int, row_bytes: int) -> int:
    """Bytes a cluster kernel's function must move for b frames of rows of
    row_bytes: the rows its counts depend on (the centre window and one
    row on each side, inside the grid) read once, counts and motion
    written."""
    y_lo, y_hi = max(geom.y_min, 0), min(geom.y_max, geom.gh)
    rows = 0 if y_hi <= y_lo else \
        min(y_hi + 1, geom.gh) - max(y_lo - 1, 0)
    return b * (rows * row_bytes + 5)


def map_bytes(geom: GridGeometry, b: int, elem: int) -> int:
    """rows_bytes of K3's votes, gw cells of elem bytes a row."""
    return rows_bytes(geom, b, geom.gw * elem)


def word_bound(geom: GridGeometry, b: int, pitch: int) -> dict:
    """K1's least time for b frames at a row pitch: the rows its counts
    depend on read once, counts and motion written; about 16 integer
    operations a word of those rows (the rule's shifts and ors, the
    centre mask, a popcount, the sum)."""
    gww = cluster_ops.word_geometry(geom)[0]
    nbytes = rows_bytes(geom, b, pitch)
    return {"nbytes": nbytes, **least_time(
        nbytes, (nbytes - 5 * b) / pitch * gww * 16)}


def expected_total(per_buffer, k: int, n: int) -> int:
    """The sum over n launches rotating over k buffers of each buffer's
    result: buffer i runs n // k times, once more for i < n % k."""
    full, rem = divmod(n, k)
    return int(sum(int(v) * (full + (1 if i < rem else 0))
                   for i, v in enumerate(per_buffer)))


def rotation(run: "Run", read_bytes: float) -> int:
    """Buffers to rotate over: enough that they hold ROTATED_BYTES of what
    a launch reads (so each launch streams from HBM), at least 2; 2 with
    --quick or on the CPU."""
    if run.quick or run.cpu:
        return 2
    return max(2, math.ceil(ROTATED_BYTES / max(read_bytes, 1.0)))


QUICK_LAUNCHES = 16


def launches(run: "Run", k: int, full: int) -> int:
    """Launches a graph captures: at least the k buffers rotated, `full`
    on the card, QUICK_LAUNCHES with --quick (enough that the replay's own
    start-up, some 25 µs, is not most of a small kernel's time), k on the
    CPU."""
    if run.cpu:
        return k
    return max(k, QUICK_LAUNCHES if run.quick else full)


def gate(seconds: float | None, nbytes: float, checksum_ok: bool) -> dict:
    """The implied rate of nbytes in seconds against the HBM roofline: the
    measurement is valid when its checksum holds and the rate is at most
    ROOFLINE_SLACK x the card's."""
    implied = nbytes / seconds if seconds else float("inf")
    valid = checksum_ok and implied <= HBM_BYTES_PER_S * ROOFLINE_SLACK
    return {"implied_gbps": implied / 1e9,
            "pct_of_roofline": 100.0 * implied / HBM_BYTES_PER_S,
            "checksum_ok": bool(checksum_ok), "valid": bool(valid)}


def card_name() -> str:
    """`name, power.limit` of card 0 as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


@dataclasses.dataclass
class Run:
    """What one bench run measures on.  ``card`` is nvidia-smi's `name,
    power.limit`, or CPU_LABEL on the CPU; ``quick`` cuts the launches a
    graph and the buffers rotated."""
    device: torch.device
    card: str
    quick: bool = False
    seed: int = 0

    @property
    def cpu(self) -> bool:
        return self.device.type == "cpu"

    @property
    def timing(self) -> str:
        if self.cpu:
            return CPU_LABEL
        return "cuda-graph, quick" if self.quick else "cuda-graph"

    def batch(self, b: int, cpu_b: int = 4) -> int:
        """Frames a launch: b on the card, cpu_b (tiny) on the CPU."""
        return min(b, cpu_b) if self.cpu else b

    def generator(self, offset: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.seed + offset)


def _sum64(outs) -> int:
    return int(torch.stack([o.sum(dtype=torch.int64) for o in outs]).sum())


def graph_time(fn, inputs, n: int, per_input, reps: int) -> dict:
    """µs a launch of fn over n launches rotating over `inputs`, captured
    in one CUDA graph and replayed `reps` times between two events, each
    after the outputs were overwritten with -1; fn(input) returns one
    int32 tensor, whose per-input sums are `per_input`.  Returns the
    replays' µs a launch and whether every replay's checksum held."""
    k = len(inputs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        # first-call work (the library, attribute calls, cached queries,
        # the allocator) before the capture
        for x in inputs[:2]:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for i in range(n):
            outs.append(fn(inputs[i % k]))
    expect = expected_total(per_input, k, n)
    graph.replay()  # the first replay uploads the graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    runs, ok = [], True
    for _ in range(reps):
        for o in outs:
            o.fill_(-1)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        runs.append(start.elapsed_time(stop) * 1e3 / n)
        ok = ok and _sum64(outs) == expect
    del graph, outs
    torch.cuda.empty_cache()
    return {"runs_us": runs, "checksum_ok": ok}


def host_clock_time(fn, inputs, n: int, per_input, reps: int) -> dict:
    """The CPU counterpart of graph_time: µs a call of fn (the plain
    versions, on CPU tensors) by the host clock, the same checksum."""
    k = len(inputs)
    runs, ok = [], True
    expect = expected_total(per_input, k, n)
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [fn(inputs[i % k]) for i in range(n)]
        runs.append((time.perf_counter() - t0) * 1e6 / n)
        ok = ok and _sum64(outs) == expect
    return {"runs_us": runs, "checksum_ok": ok}


def profiler_time(fn, inputs, kernel_name: str, calls: int = 64):
    """Mean device µs a launch of a kernel over `calls` eager calls (None
    where the trace holds no device time for it), and a line with the
    card's busy share across those calls (host clock, profiler running),
    from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            if dev_us <= 0:
                break
            return dev_us / ev.count, (
                f"{dev_us / ev.count:.3f} us over {ev.count} launches; "
                f"card busy {dev_us / window_us * 100:.2f}% of the "
                f"{window_us:.0f} us host window")
    return None, "not measured (the trace holds no device time for the kernel)"


def host_time(fn, inputs, iters: int = 256) -> float:
    """Host-clock µs a call of fn, the card never waited for inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def measure(run: Run, fn, inputs, per_input, *, n: int, nbytes: float,
            frames: int, kernel: str | None) -> dict:
    """One audited measurement of fn over the rotated inputs: µs a launch
    (the median of the replays), frames/s, the implied rate of nbytes a
    launch against the roofline, the checksum; on the card also the
    profiler's device µs (kernel: the name in the trace; skipped with
    --quick) and the host's µs a call."""
    reps = 1 if run.quick else 3
    if run.cpu:
        t = host_clock_time(fn, inputs, n, per_input, reps)
    else:
        t = graph_time(fn, inputs, n, per_input, reps)
    runs = sorted(t["runs_us"])
    us = runs[len(runs) // 2]
    out = {"runs_us": t["runs_us"], "launches": n, "buffers": len(inputs),
           "nbytes": nbytes, "timing": run.timing,
           **gate(us * 1e-6, nbytes, t["checksum_ok"])}
    # an INVALID measurement yields no value; the host's rate of the plain
    # versions is not the card's
    out["us"] = us if out["valid"] else None
    out["frames_per_s"] = frames / us * 1e6 if out["valid"] else None
    if run.cpu:
        out["implied_gbps"] = out["pct_of_roofline"] = None
    else:
        out["host_us"] = host_time(fn, inputs, 64)
        if kernel is not None and not run.quick:
            out["profiler_us"], out["profiler_text"] = profiler_time(
                fn, inputs, kernel)
    return out
