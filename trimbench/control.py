"""The control of the check: the reference put in the program's place with
one of the configuration's guarantees broken, which the check has to
refuse.

The guarantee: every analysed frame is decided on its own.  The control
takes the step a later change could be tempted by, deciding every second
frame and holding that decision for the next (half the kernel work, half
the bytes), and hands its answers to ``check.compare`` as the program's.

    python -m trimbench.control --workload mv1080_nvr --seeds 1,2,3 --files 400

prints, a seed a line, the numbers ``check.compare`` reads for the
control's answers over the first ``--files`` files of the cell's backlog.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np

from . import backlog, check, probes, scene, spec
from .reference import rule


def held_every_second(reference: check.Reference):
    def motion(kind, file_spec):
        moving, with_mvs = reference.motion(kind, file_spec)
        held = moving.copy()
        held[1::2] = moving[0::2][:len(held[1::2])]
        return held, with_mvs
    return motion


def build(cell: spec.Cell, seed: int, directory: str):
    """(specs, reference) of a cell's backlog at its own sizes."""
    camera, knobs = cell.config["camera"], cell.config["env"]
    geom = rule.Geometry.of(camera["width"], camera["height"], knobs)
    scenes = {name: scene.build(name, camera, params, geom, seed)
              for name, params in cell.config["scene"].items()}
    specs = backlog.generate(cell.traffic, camera["fps"], seed, directory)
    return specs, check.Reference(knobs, scenes, geom)


def readings(specs, reference: check.Reference, motion=None) -> dict:
    """The check's numbers for the answers ``motion`` gives (the
    reference's own where None) over ``specs``."""
    records, lists = [], {}
    for s in specs:
        want = reference.expected(s, motion)
        records.append(probes.FileRecord(s.name, 0, 0, 0, "",
                                         want.passes))
        if want.concat is not None:
            lists[s.name] = want.concat
    return check.compare(records, {s.name: s for s in specs}, lists,
                         reference)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--files", type=int, default=100)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        specs, reference = build(cell, seed, tempfile.gettempdir())
        specs = specs[:args.files]
        numbers = readings(specs, reference, held_every_second(reference))
        own = readings(specs, reference)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "files": len(specs),
                          "motion_files": int(sum(
                              bool(s.windows) for s in specs)),
                          "control": numbers, "reference": own,
                          "control_passes": check.passes(numbers),
                          "frames": int(np.sum([s.frames for s in specs]))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
