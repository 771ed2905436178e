"""Run one cell of the benchmark once:

    python -m trimbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is the result, one JSON object;
the numbers the check compared, each with its limit, are the last lines
of standard error.  Without CUDA, or with fewer cards than the cell
needs, it exits 3 and prints no result; with a JAX module loaded once
the window has closed, 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m trimbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from trimbench import harness, spec

    cell = spec.cell(args.workload)
    # the knobs, the host's thread counts among them, hold before torch
    # loads and sizes its thread pools
    os.environ.update(harness.knob_env(cell.config["env"]))
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"trimbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"trimbench: JAX modules loaded in the run: {found}",
              file=sys.stderr)
        return 4
    faults = result.pop("faults")
    for line in faults:
        print(f"fault: {line}", file=sys.stderr)
    print(f"setup: " + ", ".join(f"{k} {v}" for k, v in
                                 result["setup_parts"].items()),
          file=sys.stderr)
    for name, entry in result["checks"].items():
        (side, limit), = [(k, v) for k, v in entry.items() if k != "value"]
        print(f"check {name} {entry['value']} ({side} {limit})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
