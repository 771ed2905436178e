"""Multi-process initialization and the few collectives the archive needs.

The counterpart of ``mvtrim_tpu/parallel/distributed.py`` on
``torch.distributed``.  Every process ("rank") joins one process group
through torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the rank's card), decides
its own frames on its own card, and meets the others only in small host
collectives: one int a dispatch, the per-rank frame counts and one float64
timestamp gather at the end.

The group's backend is gloo, on host tensors, on the CPU build and on the
cards alike.  The payloads are a few bytes, so NCCL would buy nothing, and
gloo lets two ranks share one card, which NCCL does not allow.

``initialize()`` decides from the environment alone, so it is safe to call
first thing in every process, and it is idempotent.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils import logging as log

_initialized = False


def _env(name: str) -> str | None:
    # an empty variable (an unfilled compose/env template) means UNSET
    return os.environ.get(name) or None


def initialize(init_method: str | None = None,
               world_size: int | None = None,
               rank: int | None = None) -> bool:
    """Join the process group (idempotent).

    Returns True when this process is one of two or more ranks after the
    call, False for single-process operation (the default everywhere a
    launcher set no world).  ``init_method`` defaults to
    ``tcp://$MASTER_ADDR:$MASTER_PORT``.
    """
    global _initialized
    if _initialized or dist.is_initialized():
        _initialized = True
        return dist.get_world_size() > 1
    world = world_size or int(_env("WORLD_SIZE") or 1)
    if world < 2:
        return False
    if init_method is None:
        addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
        if addr is None or port is None:
            return False
        init_method = f"tcp://{addr}:{port}"
    rank = rank if rank is not None else int(_env("RANK") or 0)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=30))
    _initialized = True
    log.info(f"distributed: rank {rank} of {world} (gloo)")
    return True


def world() -> tuple[int, int]:
    """(world size, rank): (1, 0) outside a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def local_rank() -> int:
    return int(_env("LOCAL_RANK") or 0)


def allgather_ints(values) -> np.ndarray:
    """int64 [world, k]: every rank's ``values`` (k ints, the same k on
    every rank)."""
    x = torch.as_tensor(np.asarray(values, np.int64).reshape(-1))
    size, _ = world()
    if size == 1:
        return x.numpy()[None]
    out = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(out, x)
    return torch.stack(out).numpy()


def allreduce_sum(value: int) -> int:
    """The sum of ``value`` over the ranks."""
    if world()[0] == 1:
        return int(value)
    x = torch.tensor([int(value)], dtype=torch.int64)
    dist.all_reduce(x)
    return int(x[0])


def allgather_f64(x: np.ndarray) -> np.ndarray:
    """float64 [world, n]: every rank's float64 [n] vector, bit for bit
    (torch.distributed moves float64 as it is; no split into halves)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float64))
    size, _ = world()
    if size == 1:
        return t.numpy()[None]
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()
