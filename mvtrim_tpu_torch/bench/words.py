"""The words family: K1 (``csrc/word_cluster.cu``) on the bits and words
payloads, each beside C1, the stream control of its launch, and its bound.

The port's counterpart of ``benchmarks/word_bench.py`` and of the words
legs of ``bench.py`` (the headline and its stream control, the 4K pair).
Batches are seeded random bytes on the card, the bits at their own pitch
(ceil(gw / 8) bytes a row, as the scanner packs them) and the same masks
as the words payload (4 * gww bytes a row).
"""

from __future__ import annotations

import torch

from ..core.config import Config
from ..core.types import GridGeometry
from ..ops import cluster as cluster_ops
from . import audit, controls

# (label, (width, height), frames a launch): the main path's 750-frame
# chunk and the default device batch, at 1080p and 4K
CELLS = (("1080p", (1920, 1080), 750), ("1080p", (1920, 1080), 2048),
         ("4K", (3840, 2160), 2048))
LAUNCHES = 256
OPS = {"bits": cluster_ops.cluster_bits_op,
       "words": cluster_ops.cluster_words_op}


def run(r: audit.Run) -> list[dict]:
    cfg = Config()
    need = cfg.clusters_needed
    gen = r.generator(1)
    cells = []
    for label, (width, height), full_b in CELLS:
        geom = GridGeometry.build(width, height, cfg)
        b = r.batch(full_b)
        gwb = (geom.gw + 7) // 8
        gww = (geom.gw + 31) // 32
        k = audit.rotation(r, b * geom.gh * gwb)
        n = audit.launches(r, k, LAUNCHES)
        bits = [torch.randint(0, 256, (b, geom.gh, gwb), dtype=torch.uint8,
                              device=r.device, generator=gen)
                for _ in range(k)]
        ref = [int(cluster_ops.bits_cluster_counts_plain(t, geom).sum())
               for t in bits]
        for payload, op in OPS.items():
            inputs = bits if payload == "bits" else [
                cluster_ops.bits_to_words(t, geom) for t in bits]
            pitch = gwb if payload == "bits" else 4 * gww
            frame_bytes = geom.gh * pitch
            ctrl_ref = [int(controls.word_stream_control_plain(
                controls.word_rows(t, geom), geom).sum()) for t in inputs]
            kernel = audit.measure(
                r, lambda t, op=op, geom=geom: op(t, geom, need)[0], inputs,
                ref, n=n, nbytes=b * (frame_bytes + 5), frames=b,
                kernel="word_cluster_kernel")
            control = audit.measure(
                r, lambda t, geom=geom: controls.word_stream_control(t, geom),
                inputs, ctrl_ref, n=n, nbytes=b * (frame_bytes + 4),
                frames=b, kernel="word_stream_control_kernel")
            bound = audit.word_bound(geom, b, pitch)
            cells.append({
                "family": "words", "key": f"{label} B={full_b} {payload}",
                "frames": b, "bytes_per_frame": frame_bytes,
                "kernel_name": "K1 word_cluster_counts", "kernel": kernel,
                "stream_control": control,
                "bound_us": bound["bound_ms"] * 1e3,
                "bound_by": bound["bound_by"]})
        del bits, inputs
        if not r.cpu:
            torch.cuda.empty_cache()
    return cells
