"""The K1 staging slots (``models/staging.py``) and the native call that
enqueues a staged batch (``cluster_ops.cluster_staged_op``).

On the CPU the pool's pinning and waiting are a stand-in's
(``torch_staging_fakes.FakeCard``), and so is the C entry point: the
bookkeeping (a slot reused only after its resolver waited, a new slot
when all are in flight, slots handed back on every error path and across
threads) and the detector's card path against the oracle.  The cuda-
marked tests hold the real entry point to ``cluster_bits_op`` /
``cluster_words_op`` and the oracle on the card (python -m pytest -m cuda
tests/test_torch_staging.py).
"""

import gc
import sys
import threading

import numpy as np
import pytest
import torch

from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.core.types import GridGeometry
from mvtrim_tpu_torch.models import staging
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.ops import cluster as cluster_ops
from mvtrim_tpu_torch.ops.cluster import repack_bits_words

from torch_staging_fakes import DEVICE, FakeCard

FRAME = 12  # bytes a frame of the bookkeeping tests


def rows(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, (n, FRAME),
                                                dtype=np.uint8)


def any_set(slot, frames):
    """An enqueue that decides a frame by any byte set."""
    slot.motion[:frames] = slot.rows[:frames * FRAME].reshape(
        frames, FRAME).any(axis=1)


def expect(r: np.ndarray) -> np.ndarray:
    return r.any(axis=1)


class TestPool:
    def test_a_slot_is_reused_only_after_its_resolver_waited(self):
        card = FakeCard()
        pool = card.pool()
        a = rows(1, 10)
        first = staging.dispatch(pool, a, 4, any_set)  # 3 batches
        assert pool.slots == 3 and pool.free() == 0 and card.waits == []
        b = rows(2, 4)
        second = staging.dispatch(pool, b, 4, any_set)
        assert pool.slots == 4  # the first's slots are still in flight
        np.testing.assert_array_equal(first(), expect(a))
        assert card.waits == card.pinned[:3] and pool.free() == 3
        c = rows(3, 8)
        third = staging.dispatch(pool, c, 4, any_set)
        assert pool.slots == 4 and pool.free() == 1
        # taken last-in first-out: the first's last two slots, waited on
        np.testing.assert_array_equal(third(), expect(c))
        assert card.waits[3:5] == card.pinned[2:0:-1]
        np.testing.assert_array_equal(second(), expect(b))
        np.testing.assert_array_equal(first(), expect(a))  # kept, no wait
        assert len(card.waits) == 6 and pool.free() == pool.slots == 4

    def test_all_slots_in_flight_pins_a_new_one(self):
        card = FakeCard()
        pool = card.pool()
        held = [staging.dispatch(pool, rows(s, 3), 3, any_set)
                for s in range(5)]
        assert pool.slots == 5 and card.waits == [] and pool.free() == 0
        assert pool.pinned_bytes == 5 * (3 * FRAME + 3)
        for r in held:
            r()
        assert pool.free() == 5

    def test_a_slot_sized_for_the_reserve_takes_any_smaller_batch(self):
        card = FakeCard()
        pool = card.pool()
        staging.dispatch(pool, rows(1, 1), 8, any_set)()
        assert card.pinned[0].frames == 8
        staging.dispatch(pool, rows(2, 8), 8, any_set)()
        assert pool.slots == 1
        wide = np.zeros((5, 2 * FRAME), np.uint8)
        staging.dispatch(pool, wide, 8, lambda slot, n: None)()
        assert pool.slots == 2  # 8 frames of 12 bytes hold 4 of 24 only

    def test_a_resolver_that_raises_hands_its_slots_back(self):
        card = FakeCard()
        pool = card.pool()
        resolver = staging.dispatch(pool, rows(1, 9), 3, any_set)
        bad = card.pinned[1]

        def wait(slot):
            card.waits.append(slot)
            if slot is bad:
                raise RuntimeError("CUDA error 700")

        pool._wait = wait
        with pytest.raises(RuntimeError, match="700"):
            resolver()
        assert pool.free() == 3
        # each slot waited on before it went back: slot 1 twice (it raised)
        assert card.waits == [card.pinned[i] for i in (0, 1, 1, 2)]

    def test_an_enqueue_that_raises_hands_its_slots_back(self):
        card = FakeCard()
        pool = card.pool()

        def enqueue(slot, frames):
            if len(card.pinned) == 2:
                raise RuntimeError("mvt_word_cluster_batch: CUDA error 1")
            any_set(slot, frames)

        with pytest.raises(RuntimeError, match="error 1"):
            staging.dispatch(pool, rows(1, 9), 3, enqueue)
        assert pool.free() == pool.slots == 2
        assert card.waits == card.pinned

    def test_a_resolver_dropped_uncalled_hands_its_slots_back(self):
        card = FakeCard()
        pool = card.pool()
        resolver = staging.dispatch(pool, rows(1, 6), 3, any_set)
        assert pool.free() == 0
        del resolver
        gc.collect()
        assert pool.free() == 2 and card.waits == card.pinned

    @pytest.mark.parametrize("threads", [3, 12])
    def test_threads_lose_or_double_no_slot(self, threads):
        card = FakeCard()
        pool = card.pool()
        lock = threading.Lock()
        in_flight: set[int] = set()
        faults: list[str] = []

        def enqueue(slot, frames):
            with lock:
                if id(slot) in in_flight:
                    faults.append("a slot in flight was taken again")
                in_flight.add(id(slot))
            any_set(slot, frames)

        def wait(slot):
            with lock:
                in_flight.discard(id(slot))

        pool._wait = wait

        def stream(seed):
            rng = np.random.default_rng(seed)
            held = []
            for i in range(60):
                r = rows(seed * 100 + i, int(rng.integers(1, 12)))
                held.append((r, staging.dispatch(pool, r, 4, enqueue)))
                if len(held) > rng.integers(0, 4):
                    r, resolve = held.pop(0)
                    if not np.array_equal(resolve(), expect(r)):
                        faults.append("wrong motion")
            for r, resolve in held:
                if not np.array_equal(resolve(), expect(r)):
                    faults.append("wrong motion")

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            workers = [threading.Thread(target=stream, args=(s,))
                       for s in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(w.is_alive() for w in workers)
        assert faults == []
        assert in_flight == set()
        assert pool.free() == pool.slots == len(card.pinned)
        assert len({id(s) for s in pool._free}) == pool.slots


GEOM_1080 = GridGeometry.build(1920, 1080, Config())


def masks(seed: int, n: int, geom: GridGeometry) -> np.ndarray:
    rng = np.random.default_rng(seed)
    density = rng.choice([0.0, 0.003, 0.05, 0.3], size=n)[:, None, None]
    active = rng.random((n, geom.gh, geom.gw)) < density
    return np.packbits(active, axis=2, bitorder="little")


def on_fake_card(monkeypatch, cfg: Config, geom: GridGeometry):
    card = FakeCard(geom)
    pool = card.install(monkeypatch)
    det = MVClusterDetector(1920, 1080, cfg)
    det.device = DEVICE  # the card path, on the stand-in
    return card, pool, det


class TestFakeCard:
    @pytest.mark.parametrize("payload", ["bits", "words"])
    def test_the_card_path_decides_as_the_oracle(self, monkeypatch, payload):
        cfg = Config(scan_backend="torch", device_batch=750)
        card, pool, det = on_fake_card(monkeypatch, cfg, GEOM_1080)
        ref = MVClusterDetector(1920, 1080, Config(scan_backend="oracle"))
        before = cluster_ops.cluster_words_op.launches
        for seed, n in ((1, 1), (2, 750), (3, 2048)):
            bits = masks(seed, n, GEOM_1080)
            data = bits if payload == "bits" else \
                repack_bits_words(bits, GEOM_1080)
            scan = det.scan_bits_async if payload == "bits" else \
                det.scan_words_async
            np.testing.assert_array_equal(scan(data)(), ref.scan_bits(bits))
        # one launch a batch of at most 750 frames; one slot a batch in
        # flight at most, each of 750 frames
        assert cluster_ops.cluster_words_op.launches - before == 1 + 1 + 3
        assert pool.slots == 3 and pool.free() == 3
        assert {s.frames for s in card.pinned} == {750}
        assert sum(card.recorded.values()) == 5

    def test_the_card_path_checks_the_rows(self, monkeypatch):
        cfg = Config(scan_backend="torch")
        _, pool, det = on_fake_card(monkeypatch, cfg, GEOM_1080)
        with pytest.raises(TypeError):
            det.scan_bits_async(np.zeros((2, 68, 15), np.int16))
        with pytest.raises(ValueError):
            det.scan_bits_async(np.zeros((2, 68, 16), np.uint8))
        with pytest.raises(TypeError):
            det.scan_words_async(np.zeros((2, 68 * 4), np.uint32))
        assert pool.slots == 0

    def test_a_slot_too_small_is_refused_before_the_call(self, monkeypatch):
        card = FakeCard(GEOM_1080)
        card.install(monkeypatch)
        slot = card.pin(4, 68 * 15)
        with pytest.raises(ValueError, match="do not fit"):
            cluster_ops.cluster_staged_op(slot, 5, GEOM_1080, 15, 2)
        with pytest.raises(ValueError, match="do not fit"):
            cluster_ops.cluster_staged_op(slot, 4, GEOM_1080, 16, 2)
        assert card.recorded == {}


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_staging.py)")


def fresh_pools(monkeypatch):
    monkeypatch.setattr(staging, "_pools", {})


@pytest.mark.cuda
@pytest.mark.parametrize("payload", ["bits", "words"])
def test_cuda_staged_batch_decides_as_the_ops(monkeypatch, payload):
    """Batches of 1, 750 and 2048 frames at 1080p: the bits pitch of 15
    bytes (unaligned rows) and the words layout, each through one native
    call, against the op on the same rows on the card and the oracle."""
    needs_card()
    fresh_pools(monkeypatch)
    cfg = Config(scan_backend="auto", device_batch=2048)
    det = MVClusterDetector(1920, 1080, cfg)
    ref = MVClusterDetector(1920, 1080, Config(scan_backend="oracle"))
    geom = det.geom
    for seed, n in ((11, 1), (12, 750), (13, 2048)):
        bits = masks(seed, n, geom)
        data = bits if payload == "bits" else repack_bits_words(bits, geom)
        op = cluster_ops.cluster_bits_op if payload == "bits" else \
            cluster_ops.cluster_words_op
        scan = det.scan_bits_async if payload == "bits" else \
            det.scan_words_async
        before = cluster_ops.cluster_words_op.launches
        got = scan(data)()
        assert cluster_ops.cluster_words_op.launches == before + 1
        _, motion = op(torch.from_numpy(data).cuda(), geom,
                       cfg.clusters_needed)
        np.testing.assert_array_equal(got, motion.cpu().numpy())
        np.testing.assert_array_equal(got, ref.scan_bits(bits))
    pool = staging.pool_for(det.device)
    assert pool.slots == 1 and pool.free() == 1


@pytest.mark.cuda
def test_cuda_forty_files_through_one_pool(monkeypatch):
    """40 files of 1-9 chunks of up to 750 frames (device batch 512, so a
    chunk is one or two batches), three files in flight at a time as three
    streams would hold them: slots are reused while others are still in
    flight, and every decision is the oracle's."""
    needs_card()
    fresh_pools(monkeypatch)
    cfg = Config(scan_backend="auto", device_batch=512)
    ref = MVClusterDetector(1920, 1080, Config(scan_backend="oracle"))
    rng = np.random.default_rng(40)
    in_flight, batches, checked = [], 0, 0
    for f in range(40):
        det = MVClusterDetector(1920, 1080, cfg)  # one a file, as in a scan
        chunks = [masks(1000 * f + c, int(rng.integers(1, 751)), det.geom)
                  for c in range(int(rng.integers(1, 10)))]
        batches += sum(-(-len(c) // 512) for c in chunks)
        in_flight.append([(c, det.scan_bits_async(c)) for c in chunks])
        if len(in_flight) == 3:
            for c, resolve in in_flight.pop(0):
                np.testing.assert_array_equal(resolve(), ref.scan_bits(c))
                checked += 1
    for held in in_flight:
        for c, resolve in held:
            np.testing.assert_array_equal(resolve(), ref.scan_bits(c))
            checked += 1
    pool = staging.pool_for(torch.device("cuda"))
    # at most three files' batches were ever in flight
    assert pool.slots <= 3 * 9 * 2 < batches
    assert pool.free() == pool.slots
    assert checked > 40
