"""How a detector's batches reach the device: its backend and device
(``placement``), and the staging of each batch.

On a CUDA card a batch of the bits or words payload (K1) is copied into a
slot's pinned host rows (span ``detector.stage``) and handed to one native
call (``cluster_ops.cluster_staged_op``, span ``detector.enqueue``) that
copies the rows to the card, launches K1, copies the motion back into the
slot's pinned motion and records the slot's event on PyTorch's current
stream (``dispatch``); the resolver waits on the events (span
``detector.wait``) and hands the slots back.  One pool a card, shared by
the streams under a lock; a slot is pinned for ``device_batch`` frames
when no free one fits (span ``detector.pin``), and goes back once its
batch was waited on (by the resolver, its error path, or the resolver's
finalizer), so nothing is pinned once the pool holds the batches in
flight.  Every other batch goes through ``stage_and_decide``: every
payload on the CPU, and on a card the grids and raw-MV batches and the
SAD windows, whose sizes (up to about 267 MB, decided on the spot) and
capacities vary, so they do not fit slots sized for K1's batches of
about 1 KB a frame that a file holds until its scan ends.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
import weakref
from typing import Callable

import numpy as np
import torch

from ..utils.timing import SPANS

BACKENDS = ("auto", "torch", "oracle")


def resolve_backend(requested: str) -> str:
    """auto -> cuda, which needs a CUDA device; torch (the plain PyTorch
    build on the CPU) and oracle (the NumPy reference) pass through."""
    if requested not in BACKENDS:
        raise RuntimeError(
            f"MVT_SCAN_BACKEND={requested!r} is not one of "
            f"{', '.join(BACKENDS)}")
    if requested == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "MVT_SCAN_BACKEND=auto needs a CUDA device and none is "
                "available; set MVT_SCAN_BACKEND=torch for the CPU build")
        return "cuda"
    return requested


def placement(requested: str, device=None) -> tuple[str, torch.device]:
    """A detector's backend (``resolve_backend``) and device: under cuda
    the card ``device`` names (batch mode spreads streams over the cards),
    else the current one; the CPU for the other backends."""
    backend = resolve_backend(requested)
    if backend == "cuda":
        return backend, torch.device(device if device is not None
                                     else "cuda")
    return backend, torch.device("cpu")


def stage_and_decide(rows, device: torch.device, op, live_rows=None):
    """Stage one batch, decide it with ``op(tensor) -> motion bool`` on
    ``device``, and return (host, pending).  ``rows`` is one numpy array,
    or a tuple of them that ``op`` takes in order; ``live_rows`` (the
    raw-MV payload's counts) the rows of each frame that ``op`` reads.

    On a CPU device the op runs on the rows in place: ``host`` is the
    motion and ``pending`` None.  On CUDA each array is pinned, copied to
    the card without blocking and decided, and the motion is copied back
    into a pinned ``host`` behind an event, pending = (done,), for
    ``wait``.  The staged and device copies are dropped here (both
    allocators keep a freed block until the work queued on it is done),
    so a caller holding many batches holds their motion, not their rows.

    Spans: ``detector.stage`` (value: bytes staged), inside it
    ``detector.mv_rows`` where ``live_rows`` is given (zero-length; value:
    their sum), and ``detector.enqueue`` (value: frames; its launches are
    the kernels').
    """
    cuda = device.type == "cuda"
    span = SPANS.begin("detector.stage") if SPANS.on else None
    if span is not None and live_rows is not None:
        SPANS.end(SPANS.begin("detector.mv_rows"), int(live_rows.sum()))
    arrays = rows if isinstance(rows, tuple) else (rows,)
    staged = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    if cuda:
        staged = tuple(t.pin_memory() for t in staged)
    if span is not None:
        SPANS.end(span, sum(t.nbytes for t in staged))
    span = SPANS.begin("detector.enqueue") if SPANS.on else None
    if not cuda:
        host, pending = op(*staged), None
    else:
        on_device = tuple(t.to(device, non_blocking=True) for t in staged)
        motion = op(*on_device)
        host = torch.empty(motion.shape, dtype=torch.bool, pin_memory=True)
        host.copy_(motion, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        pending = (done,)
    if span is not None:
        SPANS.end(span, staged[0].shape[0])
    return host, pending


def wait(pending) -> None:
    """Wait for a batch that ``stage_and_decide`` left pending (span
    ``detector.wait``); a batch decided on the CPU has nothing to wait
    for."""
    if pending is None:
        return
    span = SPANS.begin("detector.wait") if SPANS.on else None
    pending[0].synchronize()
    if span is not None:
        SPANS.end(span)


@dataclasses.dataclass(eq=False, slots=True)
class Slot:
    """One device batch's staging, pinned once and reused.

    ``rows`` (uint8 [capacity]) and ``motion`` (bool [frames]) are NumPy
    views of the slot's pinned host memory.  ``pointers`` are what the
    native call takes: the host rows, the device rows, the device counts,
    the device motion, the host motion and the event.  ``event`` is what
    the pool's wait blocks on; ``owner`` keeps the memory behind the
    pointers alive.
    """

    frames: int
    rows: np.ndarray
    motion: np.ndarray
    device: torch.device
    pointers: tuple
    event: object
    owner: object


class StagingPool:
    """Free slots of one card, shared by threads.

    ``pin(frames, frame_bytes) -> Slot`` makes a new slot; ``wait(slot)``
    blocks until the batch last enqueued on it is done.  Both are the
    card's in ``pool_for``; tests pass their own.
    """

    def __init__(self, pin: Callable[[int, int], Slot],
                 wait: Callable[[Slot], None]):
        self._pin = pin
        self._wait = wait
        # reentrant: a resolver dropped uncalled may hand its slots back
        # from the garbage collector while this thread holds the lock
        self._lock = threading.RLock()
        self._free: list[Slot] = []
        self.slots = 0         # pinned so far
        self.pinned_bytes = 0  # host bytes pinned so far

    def take(self, frames: int, frame_bytes: int, reserve: int) -> Slot:
        """A free slot that holds ``frames`` frames of ``frame_bytes``,
        else a new one pinned for ``max(frames, reserve)`` of them (span
        ``detector.pin``, value: bytes pinned)."""
        need = frames * frame_bytes
        with self._lock:
            free = self._free
            for i in range(len(free) - 1, -1, -1):
                if free[i].frames >= frames and free[i].rows.nbytes >= need:
                    return free.pop(i)
        span = SPANS.begin("detector.pin") if SPANS.on else None
        slot = self._pin(max(frames, reserve), frame_bytes)
        nbytes = slot.rows.nbytes + slot.motion.nbytes
        with self._lock:
            self.slots += 1
            self.pinned_bytes += nbytes
        if span is not None:
            SPANS.end(span, nbytes)
        return slot

    def give(self, slots: list[Slot]) -> None:
        """Hand back slots whose batches were waited on."""
        with self._lock:
            self._free.extend(slots)

    def wait(self, slot: Slot) -> None:
        """Block until the slot's batch is done (span ``detector.wait``)."""
        span = SPANS.begin("detector.wait") if SPANS.on else None
        self._wait(slot)
        if span is not None:
            SPANS.end(span)

    def free(self) -> int:
        with self._lock:
            return len(self._free)


def _hand_back(pool: StagingPool, taken: list[Slot], waited: list[int]):
    """Wait on every slot not waited on yet, then hand all back.  A wait
    that raises (the card's error, which the caller has seen or will) is
    passed over: the slot goes back all the same."""
    for slot in taken[waited[0]:]:
        try:
            pool._wait(slot)
        except Exception:  # noqa: BLE001 — the slot must not leak
            pass
    waited[0] = len(taken)
    pool.give(taken)


def dispatch(pool: StagingPool, rows: np.ndarray, batch: int,
             enqueue: Callable[[Slot, int], None]):
    """Stage ``rows`` [N, ...] (N >= 1) in batches of ``batch`` frames,
    each in a slot of ``pool``, and ``enqueue(slot, frames)`` each; return
    the resolver, which waits for them and returns motion bool [N].

    Spans: ``detector.stage`` (taking the slot and copying the rows into
    its pinned memory; value: bytes staged) and ``detector.enqueue`` (the
    enqueue; value: frames).  The copy releases the interpreter lock.
    """
    n = rows.shape[0]
    frame_bytes = rows.nbytes // n
    taken: list[Slot] = []
    waited = [0]  # slots waited on, from the first
    try:
        for lo in range(0, n, batch):
            part = rows[lo:lo + batch]
            frames = part.shape[0]
            span = SPANS.begin("detector.stage") if SPANS.on else None
            slot = pool.take(frames, frame_bytes, batch)
            taken.append(slot)
            np.copyto(slot.rows[:part.nbytes].view(part.dtype).reshape(
                part.shape), part)
            if span is not None:
                SPANS.end(span, part.nbytes)
            span = SPANS.begin("detector.enqueue") if SPANS.on else None
            enqueue(slot, frames)
            if span is not None:
                SPANS.end(span, frames)
    except BaseException:
        _hand_back(pool, taken, waited)
        raise

    result: list[np.ndarray] = []

    def resolve() -> np.ndarray:
        if result:
            return result[0]
        try:
            out = np.empty((n,), bool)
            for i, slot in enumerate(taken):
                pool.wait(slot)
                lo = i * batch
                hi = min(lo + batch, n)
                out[lo:hi] = slot.motion[:hi - lo]
                waited[0] = i + 1
            result.append(out)
        finally:
            release()
        return out

    # called once: by the resolver, or when it is dropped uncalled
    release = weakref.finalize(resolve, _hand_back, pool, taken, waited)
    release.atexit = False
    return resolve


def _pin_cuda(device: torch.device, frames: int, frame_bytes: int) -> Slot:
    """A slot on ``device``: one pinned host block (rows, then motion) and
    one device block (rows, counts, motion), and an event without timing,
    recorded once here so that it exists.

    The event blocks its waiter (``cudaEventBlockingSync``) instead of
    spinning it.  With spinning waiters, runs of the directory batch on a
    host whose cores are shared spread about twice as widely; the likely
    cause is a resolver holding a core that the decode workers and the
    thread holding the interpreter lock could run on."""
    capacity = frames * frame_bytes
    host = torch.empty(capacity + frames, dtype=torch.uint8, pin_memory=True)
    counts_at = -(-capacity // 16) * 16
    motion_at = counts_at + 4 * frames
    card = torch.empty(motion_at + frames, dtype=torch.uint8, device=device)
    event = torch.cuda.Event(blocking=True)
    event.record(torch.cuda.current_stream(device))
    view = host.numpy()
    base, host_base = card.data_ptr(), host.data_ptr()
    return Slot(frames, view[:capacity], view[capacity:].view(np.bool_),
                device, (host_base, base, base + counts_at, base + motion_at,
                         host_base + capacity, event.cuda_event),
                event, (host, card))


def _wait_cuda(slot: Slot) -> None:
    slot.event.synchronize()


_pools: dict[int, StagingPool] = {}
_pools_lock = threading.Lock()


def pool_for(device: torch.device) -> StagingPool:
    """The pool of a CUDA device (its index, else the current one), made
    on first use and kept for the process."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    pool = _pools.get(index)
    if pool is None:
        with _pools_lock:
            pool = _pools.get(index)
            if pool is None:
                pool = _pools[index] = StagingPool(
                    functools.partial(_pin_cuda, torch.device("cuda", index)),
                    _wait_cuda)
    return pool
