"""python -m mvtrim_tpu_torch.bench [--quick] [--seed N] [--device cuda|cpu]

Times the port's kernels on the card, family by family (``words``: K1;
``grids``: K3; ``mv``: K4+K5 with the controls C3, C5-C10; ``sad``: K6 and
the SAD op), each beside the controls of its launch and its bound, by the
audit of ``audit.py``.  One line a cell on standard output, then, as the
last line and nothing after it, the headline JSON: K1 on the bits payload
at 1080p, B = 2048, in frames/s by graph timing, with the contract keys of
the JAX package's ``bench.py`` (``metric``, ``value``, ``unit``, ``impl``,
``roofline_gbps``, ``bytes_per_frame``, ``audit``), ``control_gbps``,
``pct_of_control`` and one ``secondary_<family>`` object a family.

On the card unless ``--device cpu``, which runs the plain versions at tiny
sizes by the host clock and labels every number ``cpu-plain``; without a
card and without ``--device cpu`` it exits 2.  ``--quick`` cuts the
launches a graph and the buffers rotated (the smoke run's depth).  Exits 1
when any measurement fails its audit, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import audit, grids, mv, sad, words

FAMILIES = {"words": words, "grids": grids, "mv": mv, "sad": sad}
HEADLINE = ("words", "1080p B=2048 bits")
MEASUREMENTS = {"kernel": "kernel", "op": "whole op (K6 + K3)",
                "stream_control": "stream control",
                "compute_control": "compute control",
                "capacity_control": "C6 capacity control",
                "votes_control": "C9 votes control",
                "capacity_sub_control": "C7 capacity control + sub",
                "capacity_mm_control": "C8 capacity control, low bytes",
                "matrix_control": "C10 tensor-core matrix control"}
# (family, numerator, denominator, label): ratios of device time a line
# of the family names
RATIOS = (("mv", "kernel", "compute_control",
           "K4+K5 over C5 (what C5's launch could gain, rule included)"),
          ("mv", "kernel", "votes_control",
           "K4+K5 over C9 (the same, without the rule)"),
          ("mv", "votes_control", "stream_control",
           "C9 over C3 (the scatter against the stream)"),
          ("mv", "stream_control", "capacity_control", "C3 over C6"))
AUDIT = ("CUDA graph of N launches over K rotated buffers (K x the bytes "
         "a launch reads >= 100 MB), device time between two events; "
         "int64 checksum of every launch's outputs against the plain "
         "PyTorch version weighted by the rotation; INVALID above 1.05 x "
         "3.35 TB/s, above 1.05 x 1,979 T/s of int8 tensor operations "
         "(C10), or on a checksum mismatch")


def _us(m: dict) -> str:
    if m["valid"]:
        return f"{m['us']:.3f} us"
    text = f"INVALID (checksum {'ok' if m['checksum_ok'] else 'MISMATCH'}"
    if m["implied_gbps"] is not None:
        text += f", implied {m['implied_gbps']:.1f} GB/s"
    return text + ")"


def _share(control: dict, kernel: dict) -> float | None:
    """The kernel's rate as a share of the control's: control µs over
    kernel µs, in percent."""
    if kernel["valid"] and control["valid"]:
        return 100.0 * control["us"] / kernel["us"]
    return None


def _ratio(cell: dict, num: str, den: str) -> float | None:
    """µs of measurement num over µs of den, where the cell has both
    valid."""
    if num in cell and den in cell and cell[num]["valid"] and \
            cell[den]["valid"]:
        return cell[num]["us"] / cell[den]["us"]
    return None


def _gap(m: dict) -> float | None:
    """Graph µs a launch less the profiler's device µs: the replay's own
    gaps between kernels, which the profiler's kernel spans leave out."""
    if m["valid"] and m.get("profiler_us") is not None:
        return m["us"] - m["profiler_us"]
    return None


def describe(cell: dict, card: str) -> str:
    """One line for a cell."""
    k = cell["kernel"]
    parts = [f"{cell['family']} {cell['key']} ({cell['frames']} frames a "
             f"launch, {k['launches']} launches over {k['buffers']} "
             f"buffers; {k['timing']})"]
    text = f"{cell['kernel_name']} {_us(k)} a launch"
    if k["valid"]:
        text += f", {k['frames_per_s']:,.0f} frames/s"
    if k["valid"] and k["implied_gbps"] is not None:
        text += (f", {k['implied_gbps']:.1f} GB/s = "
                 f"{k['pct_of_roofline']:.1f}% of "
                 f"{audit.HBM_BYTES_PER_S / 1e9:,.0f} GB/s")
    if "profiler_text" in k:
        text += f"; profiler: {k['profiler_text']}"
    gap = _gap(k)
    if gap is not None:
        text += f"; graph minus profiler {gap:.3f} us a launch"
    if "host_us" in k:
        text += f"; host {k['host_us']:.3f} us a call"
    parts.append(text)
    for name, label in MEASUREMENTS.items():
        m = cell.get(name)
        if name == "kernel" or m is None:
            continue
        text = f"{label} {_us(m)}"
        if m.get("profiler_us") is not None:
            text += f" (profiler {m['profiler_us']:.3f} us)"
        share = _share(m, k)
        if name == "stream_control" and share is not None:
            text += f" (the kernel at {share:.1f}% of its rate)"
        if "pct_of_ops_peak" in m and m["valid"] and \
                m["pct_of_ops_peak"] is not None:
            text += (f" ({m['implied_tops']:.1f} T operations/s = "
                     f"{m['pct_of_ops_peak']:.1f}% of the peak)")
        text += f", bound {m['bound_us']:.3f} us by {m['bound_by']}"
        parts.append(text)
    for family, num, den, label in RATIOS:
        r = _ratio(cell, num, den)
        if family == cell["family"] and r is not None:
            parts.append(f"{label} {r:.3f}")
    parts.append(f"bound {cell['bound_us']:.3f} us by {cell['bound_by']}")
    ok = all(cell[name]["checksum_ok"] for name in MEASUREMENTS
             if name in cell)
    parts.append(f"checksums {'ok' if ok else 'MISMATCH'}")
    parts.append(f"on {card}")
    return "; ".join(parts)


def summary(cell: dict) -> dict:
    """A cell's numbers for the headline's secondary object."""
    k = cell["kernel"]
    out = {"frames": cell["frames"], "us": k["us"],
           "frames_per_s": k["frames_per_s"],
           "implied_gbps": k["implied_gbps"],
           "pct_of_roofline": k["pct_of_roofline"],
           "bound_us": cell["bound_us"], "bound_by": cell["bound_by"],
           "timing": k["timing"],
           "valid": all(cell[n]["valid"] for n in MEASUREMENTS if n in cell)}
    for key in ("profiler_us", "host_us"):
        if key in k:
            out[key] = k[key]
    if _gap(k) is not None:
        out["graph_gap_us"] = _gap(k)
    for name in MEASUREMENTS:
        if name != "kernel" and name in cell:
            out[f"{name}_us"] = cell[name]["us"]
            if cell[name].get("profiler_us") is not None:
                out[f"{name}_profiler_us"] = cell[name]["profiler_us"]
            out[f"{name}_bound_us"] = cell[name]["bound_us"]
    if "stream_control" in cell:
        out["pct_of_control"] = _share(cell["stream_control"], k)
    for family, num, den, _ in RATIOS:
        if family == cell["family"] and _ratio(cell, num, den) is not None:
            out[f"{num}_over_{den}"] = _ratio(cell, num, den)
    return out


def headline(run: audit.Run, cells: list[dict]) -> dict:
    head = next(c for c in cells if (c["family"], c["key"]) == HEADLINE)
    k, c = head["kernel"], head["stream_control"]
    rec = {
        "metric": "1080p_scan_frames_per_sec_per_chip",
        "value": k["frames_per_s"], "unit": "frames/s",
        "impl": f"{'cuda' if not run.cpu else audit.CPU_LABEL} "
                f"word_cluster_counts, bits payload, 1080p, "
                f"{head['frames']} frames a launch",
        "roofline_gbps": audit.HBM_BYTES_PER_S / 1e9,
        "bytes_per_frame": head["bytes_per_frame"], "audit": AUDIT,
        "timing": run.timing, "card": run.card,
        "implied_gbps": k["implied_gbps"] if k["valid"] else None,
        "pct_of_roofline": k["pct_of_roofline"] if k["valid"] else None,
        "control_gbps": c["implied_gbps"] if c["valid"] else None,
        "pct_of_control": _share(c, k),
        "all_audited": all(cell[n]["valid"] for cell in cells
                           for n in MEASUREMENTS if n in cell)}
    for family in FAMILIES:
        rec[f"secondary_{family}"] = {
            cell["key"]: summary(cell) for cell in cells
            if cell["family"] == family}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mvtrim_tpu_torch.bench",
                                 description="Time the port's kernels on "
                                 "the card beside their controls and bounds.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="two buffers a cell, one graph replay of 16 "
                         "launches, no profiler pass")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mvtrim_tpu_torch.bench: no CUDA device; pass --device cpu "
              "to run the plain versions (no card numbers)", file=sys.stderr)
        return 2
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    card = audit.CPU_LABEL if device.type == "cpu" else audit.card_name()
    run = audit.Run(device=device, card=card, quick=args.quick,
                    seed=args.seed)
    print(f"bench on {card} ({run.timing})", flush=True)
    cells = []
    for module in FAMILIES.values():
        for cell in module.run(run):
            print(describe(cell, card), flush=True)
            cells.append(cell)
    rec = headline(run, cells)
    print(json.dumps(rec), flush=True)
    return 0 if rec["all_audited"] else 1


if __name__ == "__main__":
    sys.exit(main())
