"""The grids family: K3 (``csrc/cluster_map.cu``) beside its bound.

The port's counterpart of ``bench.py``'s ``_sweep_bench`` (K3's function
in a pass loop): uint8 vote grids at 1080p, B = 2048 (the grids payload)
at VECTORS_NEEDED, and int32 block-SAD grids at B = 64 (the SAD window)
at the SAD bound.  The TPU bench had no control for it, and neither has
this one.
"""

from __future__ import annotations

import torch

from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import cluster as cluster_ops
from ..ops import sad as sad_ops
from . import audit

# (label, (width, height), frames a launch, vote type)
CELLS = (("1080p", (1920, 1080), 2048, torch.uint8),
         ("1080p", (1920, 1080), 64, torch.int32))
LAUNCHES = 128


def run(r: audit.Run) -> list[dict]:
    cfg = Config()
    need = cfg.clusters_needed
    gen = r.generator(2)
    cells = []
    for label, (width, height), full_b, dtype in CELLS:
        geom = GridGeometry.build(width, height, cfg)
        b = r.batch(full_b)
        elem = torch.empty((), dtype=dtype).element_size()
        if dtype == torch.uint8:
            thr, high = cfg.vectors_needed, 4
        else:
            thr = sad_ops.sad_threshold_sum(cfg.sad_threshold, cfg.block_size)
            high = 2 * thr
        nbytes = audit.map_bytes(geom, b, elem)
        k = audit.rotation(r, nbytes)
        inputs = [torch.randint(0, high, (b, geom.gh, geom.gw), dtype=dtype,
                                device=r.device, generator=gen)
                  for _ in range(k)]
        ref = [int(cluster_ops.cluster_map_counts_plain(v, geom, thr).sum())
               for v in inputs]
        kernel = audit.measure(
            r, lambda v, geom=geom, thr=thr: cluster_ops.cluster_map_op(
                v, geom, thr, need)[0], inputs, ref,
            n=audit.launches(r, k, LAUNCHES), nbytes=nbytes, frames=b,
            kernel="cluster_map_kernel")
        # about 7 integer operations a centre cell (four maxima, a minimum,
        # a compare, a sum)
        bound = audit.least_time(nbytes, b * audit.centre_cells(geom) * 7)
        name = "uint8" if dtype == torch.uint8 else "int32"
        cells.append({
            "family": "grids", "key": f"{label} B={full_b} {name}",
            "frames": b, "bytes_per_frame": geom.gh * geom.gw * elem,
            "kernel_name": "K3 cluster_map_counts", "kernel": kernel,
            "bound_us": bound["bound_ms"] * 1e3,
            "bound_by": bound["bound_by"]})
        del inputs
        if not r.cpu:
            torch.cuda.empty_cache()
    return cells
