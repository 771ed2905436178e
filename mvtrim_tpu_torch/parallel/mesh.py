"""Device mesh and the sharded scan steps.

The counterpart of ``mvtrim_tpu/parallel/mesh.py``.  A mesh is a grid of
devices with two axes:

* ``data``  — frames shard across devices: each scans its rows;
* ``sweep`` — detector configs shard across devices: the same frames are
  scored under each device's configs.

A step is a host loop over the shards.  Shard (d, s) is uploaded to
``mesh.devices[d, s]`` and decided there by the port's own op (the CUDA
kernels on a card, their plain versions on the CPU).  The sweep steps
leave their decisions on the mesh's first device; the archive steps bring
theirs to the host in order.  Frames and configs are split
exactly over the axes (contiguous blocks differing by at most one): no
padding row or padding config is ever scored.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..core.config import Config
from ..core.types import GridGeometry
from ..models.staging import resolve_backend
from ..ops import cluster as cluster_ops
from ..ops import sad as sad_ops
from ..ops.sweep import sad_sweep_op, vote_sweep_op
from . import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: object array of ``torch.device``, [data, sweep]."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        data, sweep = self.devices.shape
        return {"data": data, "sweep": sweep}


def backend_device(cfg: Config | None = None) -> str:
    """'cuda' or 'cpu': where the scan backend of ``cfg`` (default:
    MVT_SCAN_BACKEND) runs — auto on the cards, torch and oracle on the
    CPU build."""
    backend = resolve_backend((cfg or Config.from_env()).scan_backend)
    return "cuda" if backend == "cuda" else "cpu"


def _kind(device: str | None) -> str:
    return torch.device(device).type if device is not None \
        else backend_device()


def build_mesh(n_devices: int | None = None, sweep: int = 1,
               device: str | None = None) -> Mesh:
    """Mesh over the caller's devices: ('data', 'sweep').

    On ``cuda`` the mesh takes the first ``n_devices`` cards (default: all),
    and asking for more cards than the host has FAILS with the inventory.
    On the CPU build (``device='cpu'``, or MVT_SCAN_BACKEND=torch/oracle)
    the mesh is ``n_devices`` CPU shards (default 1).  ``sweep`` devices
    hold distinct configs; it must divide the mesh size.
    """
    kind = _kind(device)
    if kind == "cuda":
        count = torch.cuda.device_count()
        n = n_devices or max(count, 1)
        if n > count:
            names = [torch.cuda.get_device_name(i) for i in range(count)]
            raise RuntimeError(
                f"requested a {n}-device mesh but this host has only "
                f"{count} CUDA device(s): {names}; for CPU shards set "
                f"MVT_SCAN_BACKEND=torch")
    else:
        n = n_devices or 1
    if n < 1 or n % sweep != 0:
        raise ValueError(
            f"mesh size {n} is not divisible by sweep={sweep}")
    devs = [torch.device("cuda", i) if kind == "cuda" else
            torch.device("cpu") for i in range(n)]
    grid = np.empty((n // sweep, sweep), dtype=object)
    for i, dev in enumerate(devs):
        grid[i // sweep, i % sweep] = dev
    return Mesh(grid)


def build_process_mesh(device: str | None = None) -> Mesh:
    """This rank's own mesh for a multi-process scan: one shard, the card
    ``cuda:(LOCAL_RANK % device_count)`` (ranks share cards when there are
    fewer cards than ranks), or the CPU on the CPU build."""
    kind = _kind(device)
    grid = np.empty((1, 1), dtype=object)
    grid[0, 0] = (torch.device("cuda", distributed.local_rank()
                               % torch.cuda.device_count())
                  if kind == "cuda" else torch.device("cpu"))
    return Mesh(grid)


def split(n: int, parts: int) -> list[tuple[int, int]]:
    """[lo, hi) of ``parts`` contiguous blocks covering range(n) exactly,
    sizes differing by at most one (empty blocks where parts > n)."""
    q, r = divmod(n, parts)
    bounds = np.cumsum([0] + [q + (i < r) for i in range(parts)])
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


class Staging:
    """numpy arrays -> tensors on ``device``, one upload per batch.

    On the card each array goes through a pinned buffer of its own (a
    copy, so the caller may reuse its arrays at once), copied without
    blocking.  A staging buffer must not be reused while a copy from it
    may still run, so each upload's buffers are held behind an event and
    dropped once it has passed; past ``depth`` uploads in flight the
    oldest is waited on.  So pinned memory is bounded by ``depth``
    batches, not by the clip's length.  On the CPU the ops run at once on
    the arrays themselves.
    """

    def __init__(self, device: torch.device, depth: int = 2):
        self.device = device
        self.depth = depth
        self.in_flight: collections.deque = collections.deque()

    def upload(self, arrays) -> list[torch.Tensor]:
        if self.device.type == "cpu":
            return [torch.from_numpy(a) for a in arrays]
        while self.in_flight and (len(self.in_flight) >= self.depth
                                  or self.in_flight[0][0].query()):
            done, _ = self.in_flight.popleft()
            done.synchronize()
        pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
        out = [p.to(self.device, non_blocking=True) for p in pinned]
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self.in_flight.append((done, pinned))
        return out


def _shard_runner(mesh: Mesh):
    """``run(pieces) -> [motion]``: decide shards on their devices.
    ``pieces`` is a list of (device, arrays, op), ``op(*tensors) -> bool
    tensor``; each piece's arrays go up through that device's ``Staging``
    and its op is enqueued before the next piece is staged, so shards on
    different cards overlap.  Each shard's decisions stay on its device."""
    staging = {dev: Staging(dev) for dev in mesh.devices.ravel()}

    def run(pieces) -> list[torch.Tensor]:
        return [op(*staging[device].upload(
                    [np.ascontiguousarray(a) for a in arrays]))
                for device, arrays, op in pieces]

    return run


def _to_host(motions: list[torch.Tensor]) -> np.ndarray:
    """Row-shards' decisions, in order, as one numpy vector."""
    if not motions:
        return np.zeros((0,), bool)
    return np.concatenate([m.cpu().numpy() for m in motions])


def _gather(mesh: Mesh, shape, where, motions) -> torch.Tensor:
    """Shard decisions placed at ``where`` [(lo, hi, c0, c1)] of one bool
    [B, K] tensor on the mesh's first device (the shard's own tensor where
    one shard holds it all)."""
    n, k = shape
    if len(motions) == 1 and where[0] == (0, n, 0, k):
        return motions[0]
    out = torch.zeros(shape, dtype=torch.bool, device=mesh.devices[0, 0])
    for (lo, hi, c0, c1), m in zip(where, motions):
        out[lo:hi, c0:c1] = m.to(out.device)
    return out


def shard_votes(votes: np.ndarray, mesh: Mesh) -> list[torch.Tensor]:
    """A [B, ...] batch split exactly over the 'data' axis: one tensor per
    shard, on that shard's device."""
    return [torch.from_numpy(np.ascontiguousarray(votes[lo:hi]))
            .to(mesh.devices[d, 0])
            for d, (lo, hi) in enumerate(split(len(votes),
                                               mesh.shape["data"]))]


def _configs_by_sweep(k: int, mesh: Mesh):
    return [(s, lo, hi) for s, (lo, hi) in enumerate(
        split(k, mesh.shape["sweep"])) if hi > lo]


def sharded_scan_step(geom: GridGeometry, cfg: Config, mesh: Mesh,
                      sweep_clusters: bool = False):
    """The vote-level sweep over a mesh (``tune --mesh`` on grids).

    Returns ``step(votes, vec_needs[, clu_needs]) -> (motion, counts)``:
    votes uint8 [B, gh, gw] split over 'data', vec_needs int32 [K] (and,
    with ``sweep_clusters``, clu_needs int32 [K]) split over 'sweep';
    motion bool [B, K] and counts int64 [K], the motion frames of each
    config, both tensors on the mesh's first device.  Without
    ``sweep_clusters`` every config takes max(1, CLUSTERS_NEEDED).  Shard
    (d, s) runs the cluster-map kernel once per config of block s over the
    rows of block d.
    """
    run = _shard_runner(mesh)

    def step(votes, vec_needs, clu_needs=None):
        vec_needs = np.asarray(vec_needs, np.int32)
        if clu_needs is None:
            clu_needs = np.full(vec_needs.shape, cfg.clusters_needed,
                                np.int32)
        clu_needs = np.asarray(clu_needs, np.int32)
        k = len(vec_needs)
        pieces, where = [], []
        for d, (lo, hi) in enumerate(split(len(votes), mesh.shape["data"])):
            if hi == lo:
                continue
            for s, c0, c1 in _configs_by_sweep(k, mesh):
                def op(v, c0=c0, c1=c1):
                    return vote_sweep_op(v, geom, vec_needs[c0:c1],
                                         clu_needs[c0:c1])
                pieces.append((mesh.devices[d, s], (votes[lo:hi],), op))
                where.append((lo, hi, c0, c1))
        motion = _gather(mesh, (len(votes), k), where, run(pieces))
        return motion, motion.sum(dim=0)

    return step


def sharded_bits_scan_step(geom: GridGeometry, cfg: Config, mesh: Mesh):
    """The packed-bits archive step.

    Returns ``step(bits) -> (motion, count)``: bits uint8 [B, gh,
    ceil(gw/8)] (the native mvt_scan_bits layout) split over 'data', each
    shard decided by the word-domain kernel at the bits' own row pitch
    (``cluster_bits_op``); motion bool [B] and its count.  The activity
    threshold is baked in host-side, so a 'sweep' axis carries nothing.
    """
    run = _shard_runner(mesh)

    def op(bits):
        return cluster_ops.cluster_bits_op(bits, geom,
                                           cfg.clusters_needed)[1]

    def step(bits):
        pieces = [(mesh.devices[d, 0], (bits[lo:hi],), op) for d, (lo, hi)
                  in enumerate(split(len(bits), mesh.shape["data"]))
                  if hi > lo]
        motion = _to_host(run(pieces))
        return motion, int(motion.sum())

    return step


def _windows(n: int, mesh: Mesh):
    """Shard d of n SAD frames held as luma [1 + n, H, W] (row 0 the
    predecessor of frame 0): its window is rows [lo, hi + 1), the frame
    before its first frame then its frames, a view of the same buffer."""
    return [(d, lo, hi) for d, (lo, hi) in enumerate(
        split(n, mesh.shape["data"])) if hi > lo]


def sharded_sad_scan_step(geom: GridGeometry, cfg: Config, mesh: Mesh):
    """The pixel-domain archive step (MV-less archives).

    Returns ``step(luma, valid) -> (motion, count)``: luma uint8 [1 + B, H,
    W], unpadded, row 0 the frame before row 1 in feed order; valid bool
    [B], False where a frame has no true predecessor (a chunk's first
    analyzed frame, or a placeholder row).  Shard d of the B frames is
    decided on its window of the same buffer (its carry as row 0) by the
    block-SAD kernel and then the cluster-map kernel (``sad_op``), at the
    SAD bound and CLUSTERS_NEEDED of ``cfg``, exactly as SADDetector
    decides; motion = that & valid.
    """
    run = _shard_runner(mesh)

    def op(window):
        return sad_ops.sad_op(window, geom, sad_threshold=cfg.sad_threshold,
                              block_size=cfg.block_size,
                              clusters_needed=cfg.clusters_needed)[1]

    def step(luma, valid):
        n = luma.shape[0] - 1
        pieces = [(mesh.devices[d, 0], (luma[lo:hi + 1],), op)
                  for d, lo, hi in _windows(n, mesh)]
        motion = _to_host(run(pieces)) & valid
        return motion, int(motion.sum())

    return step


def sharded_sad_sweep_step(geom: GridGeometry, cfg: Config, mesh: Mesh):
    """The pixel-domain sweep over a mesh (``tune --mesh --scan-input
    sad``).

    Returns ``step(luma, bounds, clus) -> motion bool [B, K]``, a tensor
    on the mesh's first device: luma uint8 [1 + B, H, W] as in
    ``sharded_sad_scan_step``, frames split over 'data'; bounds (integer
    SAD-sum bounds, ``sad.sad_threshold_sum``) and clus (raw
    CLUSTERS_NEEDED) [K] split over 'sweep'.  Shard (d, s) runs the
    block-SAD kernel once on its window and the cluster-map kernel once
    per config of block s.
    """
    run = _shard_runner(mesh)

    def step(luma, bounds, clus):
        bounds, clus = np.asarray(bounds, np.int64), np.asarray(clus)
        n, k = luma.shape[0] - 1, len(bounds)
        pieces, where = [], []
        for d, lo, hi in _windows(n, mesh):
            for s, c0, c1 in _configs_by_sweep(k, mesh):
                def op(window, c0=c0, c1=c1):
                    return sad_sweep_op(window, geom, cfg.block_size,
                                        bounds[c0:c1], clus[c0:c1])
                pieces.append((mesh.devices[d, s], (luma[lo:hi + 1],), op))
                where.append((lo, hi, c0, c1))
        return _gather(mesh, (n, k), where, run(pieces))

    return step


def stream_device_assignment(n_streams: int, mesh: Mesh) -> list[int]:
    """Round-robin multi-video streams onto mesh devices (replaces the
    reference's disjoint per-stream cpusets, batch_processor.cpp:101-110)."""
    n_dev = mesh.devices.size
    return [i % n_dev for i in range(n_streams)]
