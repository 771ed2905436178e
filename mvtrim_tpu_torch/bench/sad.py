"""The sad family: K6 (``csrc/sad_block.cu``) and the whole SAD op (K6 then
K3 on its grid) on 64-frame windows, beside C2, the stream control of K6's
launch, C4, K6's body over one resident frame, and the bound.

The port's counterpart of ``benchmarks/sad_bench.py`` and of ``bench.py``'s
SAD secondary: windows [1 + 64, H, W] at 1080p and 4K, drawn on the card
as sad_bench.py draws them (a static noise background, a bright 120-pixel
square on every third frame), so K3 decides frames both ways.
"""

from __future__ import annotations

import torch

from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import cluster as cluster_ops
from ..ops import sad as sad_ops
from . import audit, controls

CELLS = (("1080p", (1920, 1080)), ("4K", (3840, 2160)))
WINDOW = 64
LAUNCHES = 16


def window(gen: torch.Generator, b: int, width: int, height: int,
           device: torch.device) -> torch.Tensor:
    """Seeded luma uint8 [1 + b, height, width]."""
    base = torch.randint(0, 200, (height, width), dtype=torch.uint8,
                         device=device, generator=gen)
    luma = base.expand(1 + b, height, width).clone()
    for i in range(1, 1 + b, 3):
        y = 64 + (i * 37) % (height - 200)
        x = 64 + (i * 53) % (width - 200)
        luma[i, y:y + 120, x:x + 120] = 255
    return luma


def run(r: audit.Run) -> list[dict]:
    cfg = Config()
    bs, need = cfg.block_size, cfg.clusters_needed
    bound = sad_ops.sad_threshold_sum(cfg.sad_threshold, bs)
    gen = r.generator(4)
    cells = []
    for label, (width, height) in CELLS:
        geom = GridGeometry.build(width, height, cfg)
        b = r.batch(WINDOW, 2)
        plane = height * width
        grid_bytes = b * geom.gh * geom.gw * 4
        k = audit.rotation(r, (1 + b) * plane)
        inputs = [window(gen, b, width, height, r.device) for _ in range(k)]
        grids = [sad_ops.sad_block_grid_plain(w, bs) for w in inputs]
        ref = [int(g.sum(dtype=torch.int64)) for g in grids]
        op_ref = [int(cluster_ops.cluster_map_counts_plain(
            g, geom, bound).sum()) for g in grids]
        del grids
        ctrl_ref = [int(controls.sad_stream_control_plain(w, bs).sum(
            dtype=torch.int64)) for w in inputs]
        comp_ref = [int(controls.sad_compute_control_plain(w, bs).sum(
            dtype=torch.int64)) for w in inputs]

        def op(w, geom=geom):
            return sad_ops.sad_op(w, geom, sad_threshold=cfg.sad_threshold,
                                  block_size=bs, clusters_needed=need)[0]

        # sad_grid_op takes only card tensors; the CPU run times the plain
        # version
        grid_op = (lambda w: sad_ops.sad_block_grid_plain(w, bs)) if r.cpu \
            else (lambda w, geom=geom: sad_ops.sad_grid_op(w, geom, bs))
        n = audit.launches(r, k, LAUNCHES)
        # the window read once (the carry plane too), the int32 grid
        # written; the op adds K3's read of the grid rows its counts need
        nbytes = (1 + b) * plane + grid_bytes
        out = {
            "kernel": audit.measure(
                r, grid_op, inputs, ref, n=n, nbytes=nbytes, frames=b,
                kernel="sad_block_kernel"),
            "op": audit.measure(
                r, op, inputs, op_ref, n=n,
                nbytes=nbytes + audit.map_bytes(geom, b, 4), frames=b,
                kernel=None),
            "stream_control": audit.measure(
                r, lambda w, geom=geom: controls.sad_stream_control(
                    w, geom, bs), inputs, ctrl_ref, n=n, nbytes=nbytes,
                frames=b, kernel="sad_stream_control_kernel"),
            "compute_control": audit.measure(
                r, lambda w, geom=geom: controls.sad_compute_control(
                    w, geom, bs), inputs, comp_ref, n=n,
                nbytes=2 * plane + grid_bytes, frames=b,
                kernel="sad_block_resident_kernel")}
        # two integer operations a pixel (|difference|, sum)
        bnd = audit.least_time(nbytes, b * plane * 2)
        cells.append({
            "family": "sad", "key": f"{label} B={WINDOW}", "frames": b,
            "bytes_per_frame": plane, "kernel_name": "K6 sad_block_grid",
            "bound_us": bnd["bound_ms"] * 1e3, "bound_by": bnd["bound_by"],
            **out})
        del inputs
        if not r.cpu:
            torch.cuda.empty_cache()
    return cells
