"""A stand-in card for the K1 staging path on the CPU.

``FakeCard`` pins slots in plain host memory, waits on nothing (it counts
the waits), and stands in for the C entry point ``mvt_word_cluster_batch``
with Python that does what the entry point does through the same pointers:
copy the host rows to the "device" rows, count them by the plain PyTorch
version of the kernel, copy the motion to the host motion, "record" the
event.  With it the detector's card path (``_dispatch_staged``), the pool
and the launch counting run on the CPU.
"""

from __future__ import annotations

import ctypes
import itertools

import numpy as np
import torch

from mvtrim_tpu_torch.core.types import GridGeometry
from mvtrim_tpu_torch.models import staging
from mvtrim_tpu_torch.ops import _build
from mvtrim_tpu_torch.ops import cluster as cluster_ops

DEVICE = torch.device("cuda", 0)


def _bytes_at(address: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(address))


class FakeCard:
    def __init__(self, geom: GridGeometry | None = None):
        self.geom = geom
        self.pinned = []       # slots, in the order they were pinned
        self.waits = []        # slots waited on, in order
        self.recorded = {}     # event id -> times recorded
        self._events = itertools.count(1)

    def pin(self, frames: int, frame_bytes: int) -> staging.Slot:
        capacity = frames * frame_bytes
        host = np.zeros(capacity + frames, np.uint8)
        card = np.zeros(capacity + 5 * frames, np.uint8)
        event = next(self._events)
        base, host_base = card.ctypes.data, host.ctypes.data
        slot = staging.Slot(
            frames, host[:capacity], host[capacity:].view(np.bool_), DEVICE,
            (host_base, base, base + capacity, base + capacity + 4 * frames,
             host_base + capacity, event), event, (host, card))
        self.pinned.append(slot)
        return slot

    def wait(self, slot: staging.Slot) -> None:
        self.waits.append(slot)

    def pool(self) -> staging.StagingPool:
        return staging.StagingPool(self.pin, self.wait)

    def entry(self, host_rows, rows, batch, gh, pitch, gw, y_min, y_max,
              need, counts, motion, host_motion, event, device, stream):
        """``mvt_word_cluster_batch`` through its pointers."""
        assert (gh, gw, y_min, y_max) == (self.geom.gh, self.geom.gw,
                                          self.geom.y_min, self.geom.y_max)
        assert device == DEVICE.index and stream == 1000 + device
        n = batch * gh * pitch
        ctypes.memmove(rows, host_rows, n)
        frames = torch.from_numpy(_bytes_at(rows, n).copy()).reshape(
            batch, gh, pitch)
        words = torch.nn.functional.pad(frames, (0, 4 * ((gw + 31) // 32)
                                                 - pitch))
        words = words.reshape(batch, -1).view(torch.int32)
        got = cluster_ops.word_cluster_counts_plain(words, self.geom).numpy()
        _bytes_at(counts, 4 * batch)[:] = got.view(np.uint8)
        _bytes_at(motion, batch)[:] = got >= need
        ctypes.memmove(host_motion, motion, batch)
        self.recorded[event] = self.recorded.get(event, 0) + 1
        return 0

    def install(self, monkeypatch) -> staging.StagingPool:
        """The detector's card path on this stand-in: its pool as card 0's,
        its entry point as the library's, a stream of 1000 + the index."""
        pool = self.pool()
        monkeypatch.setitem(staging._pools, DEVICE.index, pool)
        monkeypatch.setitem(_build._entries, "mvt_word_cluster_batch",
                            self.entry)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda index: 1000 + index, raising=False)
        return pool
