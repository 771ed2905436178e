"""The mv family: K4+K5 (``csrc/mv_cluster.cu``) beside C3, the rows below
the counts streamed on a launch of small CTAs that take the frames in
turn, C5, its whole rule over one held frame on that kind of launch, C6,
its launch over all M slots (capacity, not count), C9, its vote scatter
without the cluster rule on C3's kind of launch, and its bound; at full
counts also C7 and C8 (C6 with a second dst_x stream, with the fields' low
bytes) and C10, the one-hot vote product's shapes on the tensor cores.
Each cell's line names K4+K5 over C5 (what moving K4+K5 onto that launch
could gain, its rule included), K4+K5 over C9 (the same without the
rule), C9 over C3 (the scatter against the stream of the same rows) and
C3 over C6 (reading by count against reading by capacity).

The port's counterpart of ``benchmarks/mv_bench.py`` and of ``bench.py``'s
fused-MV secondary: B = 2048 frames a launch at 1080p (capacity M = 8192)
and 4K (M = 16384), with sparse counts (log-uniform in 64..2048, the
densities of real 1080p streams, as mv_bench.py draws them) and full
counts.  MV fields are drawn on the card as mv_bench.py draws them: dst
uniform over the frame and 32 pixels past it, src within 8 pixels of dst.
"""

from __future__ import annotations

import math

import torch

from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import mv_vote as mv_ops
from . import audit, controls

# (label, (width, height), capacity M, counts)
CELLS = (("1080p", (1920, 1080), 8192, "sparse"),
         ("1080p", (1920, 1080), 8192, "full"),
         ("4K", (3840, 2160), 16384, "sparse"),
         ("4K", (3840, 2160), 16384, "full"))
FRAMES = 2048
SPARSE = (64, 2048)
LAUNCHES = 32


def draw(gen: torch.Generator, b: int, m: int, width: int, height: int,
         counts_mode: str, device: torch.device):
    """Seeded (mvs int16 [b, m, 4], counts int32 [b]) on `device`."""
    def rand(lo, hi):
        return torch.randint(lo, hi, (b, m), dtype=torch.int16,
                             device=device, generator=gen)

    dst_x, dst_y = rand(-32, width + 32), rand(-32, height + 32)
    mvs = torch.stack([dst_x, dst_y, dst_x - rand(-8, 9),
                       dst_y - rand(-8, 9)], dim=2)
    if counts_mode == "full":
        counts = torch.full((b,), m, dtype=torch.int32, device=device)
    else:
        lo, hi = min(SPARSE[0], m), min(SPARSE[1], m)
        u = torch.rand((b,), generator=gen, device=device,
                       dtype=torch.float64)
        counts = torch.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo))
                           ).to(torch.int32).clamp(max=m)
    return mvs, counts


def full_count_controls(r: audit.Run, inputs, geom: GridGeometry,
                        n: int) -> dict:
    """C7, C8 and C10 over the rotated inputs (none depends on the
    counts): C7 with a contiguous copy of each input's dst_x."""
    b, m, _ = inputs[0][0].shape
    subs = [(f, c, f[..., 0].contiguous()) for f, c in inputs]

    def matrix(fc):
        return controls.mv_matrix_control(fc[0], geom)

    return {
        "capacity_sub_control": audit.measure(
            r, lambda fcs: controls.mv_capacity_control_sub(*fcs), subs,
            [int(controls.mv_capacity_control_sub_plain(*fcs).sum())
             for fcs in subs], n=n, nbytes=b * (m * 10 + 8), frames=b,
            kernel="mv_capacity_control_kernel"),
        "capacity_mm_control": audit.measure(
            r, lambda fc: controls.mv_capacity_control_mm(*fc), inputs,
            [int(controls.mv_capacity_control_mm_plain(*fc).sum())
             for fc in inputs], n=n, nbytes=b * (m * 8 + 8), frames=b,
            kernel="mv_capacity_control_kernel"),
        "matrix_control": audit.measure(
            r, matrix, inputs,
            [int(controls.mv_matrix_control_plain(f, geom).sum())
             for f, _ in inputs], n=n, nbytes=b * (m * 8 + 4), frames=b,
            kernel="mv_matrix_control_kernel",
            ops=controls.matrix_ops(geom, b, m),
            ops_per_s=audit.TENSOR_INT8_OPS_PER_S)}


def run(r: audit.Run) -> list[dict]:
    cfg = Config()
    bnd = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    vec, need, shift = cfg.vectors_needed, cfg.clusters_needed, cfg.block_shift
    gen = r.generator(3)
    cells = []
    for label, (width, height), m, counts_mode in CELLS:
        geom = GridGeometry.build(width, height, cfg)
        b = r.batch(FRAMES)
        # rows below the counts, 8 bytes each, at the mean count
        mean_rows = b * (m if counts_mode == "full" else
                         (SPARSE[1] - SPARSE[0])
                         / math.log(SPARSE[1] / SPARSE[0]))
        k = audit.rotation(r, mean_rows * 8)
        inputs = [draw(gen, b, m, width, height, counts_mode, r.device)
                  for _ in range(k)]
        rows = sum(int(c.clamp(0, m).sum()) for _, c in inputs) / k
        first = sum(int(c[0].clamp(0, m)) for _, c in inputs) / k

        def kernel(fc, geom=geom):
            return mv_ops.mv_cluster_op(fc[0], fc[1], geom, bnd, vec, need,
                                        shift)[0]

        def compute(fc, geom=geom):
            return controls.mv_compute_control(fc[0], fc[1], geom, bnd, vec,
                                               need, shift)[0]

        def votes(fc, geom=geom):
            return controls.mv_votes_control(fc[0], fc[1], geom, bnd, shift)

        ref = [int(mv_ops.mv_cluster_counts_plain(
            f, c, geom, bnd, vec, shift).sum()) for f, c in inputs]
        ctrl_ref = [int(controls.mv_stream_control_plain(f, c).sum())
                    for f, c in inputs]
        comp_ref = [int(controls.mv_compute_control_plain(
            f, c, geom, bnd, vec, need, shift)[0].sum()) for f, c in inputs]
        n = audit.launches(r, k, LAUNCHES)
        # each launch reads the rows below the counts and the counts, and
        # writes 5 bytes a frame (4 for the controls); the capacity controls
        # read all M slots
        out = {
            "kernel": audit.measure(
                r, kernel, inputs, ref, n=n, nbytes=rows * 8 + b * 9,
                frames=b, kernel="mv_cluster_kernel"),
            "stream_control": audit.measure(
                r, lambda fc: controls.mv_stream_control(*fc), inputs,
                ctrl_ref, n=n, nbytes=rows * 8 + b * 8, frames=b,
                kernel="mv_stream_control_kernel"),
            "compute_control": audit.measure(
                r, compute, inputs, comp_ref, n=n,
                nbytes=first * 8 + 4 + b * 5, frames=b,
                kernel="mv_compute_control_kernel"),
            "capacity_control": audit.measure(
                r, lambda fc: controls.mv_capacity_control(*fc), inputs,
                [int(controls.mv_capacity_control_plain(*fc).sum())
                 for fc in inputs], n=n, nbytes=b * (m * 8 + 8), frames=b,
                kernel="mv_capacity_control_kernel"),
            "votes_control": audit.measure(
                r, votes, inputs,
                [int(controls.mv_votes_control_plain(
                    f, c, geom, bnd, shift).sum()) for f, c in inputs],
                n=n, nbytes=rows * 8 + b * 8, frames=b,
                kernel="mv_votes_control_kernel", ops=rows * 12)}
        if counts_mode == "full":
            out.update(full_count_controls(r, inputs, geom, n))
        # about 12 integer operations an MV (two differences, two products,
        # a sum, the bound, two shifts, four range tests) and 8 a centre
        # cell (the rule's 7 and the histogram's zeroing)
        bound = audit.least_time(rows * 8 + b * 9,
                                 rows * 12 + b * audit.centre_cells(geom) * 8)
        cells.append({
            "family": "mv", "key": f"{label} M={m} {counts_mode}",
            "frames": b, "bytes_per_frame": rows * 8 / b,
            "mean_count": rows / b, "kernel_name": "K4+K5 mv_cluster_counts",
            "bound_us": bound["bound_ms"] * 1e3,
            "bound_by": bound["bound_by"], **out})
        del inputs
        if not r.cpu:
            torch.cuda.empty_cache()
    return cells
