"""One traced run of a cell, read through the program's own spans:

    python -m trimbench.program_trace --workload <name> --seed <n> --seconds <s>

prints the run's result line (as ``python -m trimbench --trace 1``
prints it) and then one JSON object: the card's 10 longest idle gaps
named by the benchmark's spans (``idle_gaps``) and by the program's
innermost spans (``idle_gaps_program``), the program's spans a file and
a second, each name's count, mean and off-CPU share, and two clock
checks.  ``k1_before_its_enqueue``
counts the K1 operations in the window that start before as many
launches were enqueued (``detector.enqueue`` spans that began before
it) as K1 operations started up to it: 0 where the clocks agree.  ``inside_share``: the program's ``detector.stage``,
``detector.enqueue`` and ``detector.wait`` time over the benchmark's
``dispatch:*`` and ``resolve`` time (the first lie inside the second).
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import time

T_START = time.perf_counter()

KERNEL = "word_cluster_kernel"


def clock_checks(run, spans) -> dict:
    enqueues = sorted((s.start_ns, s.launches) for s in spans
                      if s.name == "detector.enqueue" and s.launches
                      and run.t0_ns <= s.start_ns <= run.t1_ns)
    starts = [t for t, _ in enqueues]
    launched, total = [], 0
    for _, n in enqueues:
        total += n
        launched.append(total)
    k1 = sorted(op.start_ns for op in run.ops
                if op.kind == "kernel" and KERNEL in op.name)
    late, lags = 0, []
    for k, start in enumerate(k1, 1):
        i = bisect.bisect_right(starts, start)
        if i == 0 or launched[i - 1] < k:
            late += 1
        else:
            lags.append(start - starts[i - 1])
    inside = sum(s.end_ns - s.start_ns for s in spans
                 if s.name in ("detector.stage", "detector.enqueue",
                               "detector.wait")
                 and run.t0_ns <= s.start_ns <= run.t1_ns)
    outside = sum(s[2] - s[1] for s in run.window_spans("dispatch:")
                  + run.window_spans("resolve"))
    lags.sort()
    return {"k1_ops": len(k1), "k1_before_its_enqueue": late,
            "k1_lag_us_min_median": [lags[0] / 1e3,
                                     lags[len(lags) // 2] / 1e3]
            if lags else None,
            "inside_share": inside / outside if outside else None,
            "inside_s": inside / 1e9, "dispatch_resolve_s": outside / 1e9}


def by_name(spans) -> dict:
    """Per span name: count, mean wall ms, and the share of wall time off
    a core (wall minus the thread's CPU time)."""
    out = {}
    for name in sorted({s.name for s in spans}):
        these = [s for s in spans if s.name == name]
        wall = sum(s.end_ns - s.start_ns for s in these)
        cpu = sum(s.cpu_ns for s in these)
        out[name] = {"n": len(these), "mean_ms": wall / len(these) / 1e6,
                     "offcpu_pct": 100.0 * (wall - cpu) / wall
                     if wall else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trimbench.program_trace")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from trimbench import harness, program, spec

    cell = spec.cell(args.workload)
    os.environ.update(harness.knob_env(cell.config["env"]))
    import torch

    if not torch.cuda.is_available():
        print("trimbench.program_trace: needs a CUDA card", file=sys.stderr)
        return 3
    kept = []
    made = harness.Run

    def keep(**fields):
        kept.append(made(**fields))
        return kept[-1]

    harness.Run = keep
    try:
        result = harness.run_cell(cell, args.seed, args.seconds, True,
                                  t_start=T_START)
    finally:
        harness.Run = made
    result.pop("faults")
    print(json.dumps(result), flush=True)
    run = kept[-1]
    spans = program.spans(run) or []
    inside = [s for s in spans if run.t0_ns <= s.start_ns <= run.t1_ns]
    files = {s.file for s in inside if s.name == "pipeline.probe"}
    names = collections.Counter(s.name for s in inside)
    print(json.dumps({
        "idle_gaps": result.get("breakdown", {}).get("idle_gaps"),
        "idle_gaps_program": program.idle_gaps(run),
        "spans": len(inside), "files": len(files),
        "spans_per_file": len(inside) / max(1, len(files)),
        "spans_a_file": {k: v / max(1, len(files))
                         for k, v in sorted(names.items())},
        "spans_a_second": len(inside) / run.window_s,
        "by_name": by_name(inside),
        "clock": clock_checks(run, spans)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
