"""mvtrim_tpu_torch MVClusterDetector vs the JAX detector and the oracle.

The port runs its plain PyTorch build (``scan_backend="torch"``); the JAX
detector runs its XLA build.  Seeded numpy masks; decisions must be
identical.
"""

import numpy as np
import pytest
import torch

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.models.mv_detector import MVClusterDetector as JaxDetector
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.models import mv_detector as torch_detector
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.ops.cluster import repack_bits_words

DIMS = [(640, 480), (1920, 1080)]


def packed(seed, n, det):
    rng = np.random.default_rng(seed)
    density = rng.choice([0.0, 0.003, 0.05, 0.3], size=n)[:, None, None]
    active = rng.random((n, det.geom.gh, det.geom.gw)) < density
    return np.packbits(active, axis=2, bitorder="little")


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("n", [0, 1, 40])
class TestScanParity:
    def test_bits_and_words_match_jax_and_oracle(self, dims, n):
        """device_batch 16 < 40 frames: several dispatches per scan."""
        port = MVClusterDetector(*dims, Config(scan_backend="torch",
                                               device_batch=16))
        assert port.device_batch == 16
        jax_det = JaxDetector(*dims, JaxConfig(scan_backend="xla",
                                               device_batch=16))
        ref = MVClusterDetector(*dims, Config(scan_backend="oracle"))
        bits = packed(n + dims[0], n, port)
        words = repack_bits_words(bits, port.geom)

        expect = jax_det.scan_bits(bits)
        assert expect.shape == (n,) and expect.dtype == bool
        np.testing.assert_array_equal(port.scan_bits(bits), expect)
        np.testing.assert_array_equal(port.scan_words(words), expect)
        np.testing.assert_array_equal(ref.scan_bits(bits), expect)
        np.testing.assert_array_equal(ref.scan_words(words), expect)
        np.testing.assert_array_equal(jax_det.scan_words(words), expect)


class TestDetector:
    def test_resolvers_called_out_of_order(self):
        det = MVClusterDetector(640, 480, Config(scan_backend="torch",
                                                 device_batch=8))
        ref = MVClusterDetector(640, 480, Config(scan_backend="oracle"))
        chunks = [packed(s, n, det) for s, n in ((1, 20), (2, 3), (3, 17))]
        resolvers = [det.scan_bits_async(c) for c in chunks]
        for i in (2, 0, 1, 2):
            np.testing.assert_array_equal(resolvers[i](),
                                          ref.scan_bits(chunks[i]))

    def test_device_batch_is_frames_per_dispatch(self, monkeypatch):
        """No rounding to multiples of 8 or 128 (a TPU tiling rule)."""
        det = MVClusterDetector(640, 480, Config(scan_backend="torch",
                                                 device_batch=5))
        assert det.device_batch == 5
        calls = []
        real = torch_detector.cluster_ops.cluster_words_op

        def spy(words, geom, need):
            calls.append(words.shape[0])
            return real(words, geom, need)

        monkeypatch.setattr(torch_detector.cluster_ops, "cluster_words_op",
                            spy)
        det.scan_bits(packed(4, 12, det))
        assert calls == [5, 5, 2]

    def test_auto_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="MVT_SCAN_BACKEND=torch"):
            MVClusterDetector(640, 480, Config())

    @pytest.mark.parametrize("backend", ["xla", "pallas", "cuda"])
    def test_unknown_backend_raises(self, backend):
        with pytest.raises(RuntimeError, match="not one of"):
            MVClusterDetector(640, 480, Config(scan_backend=backend))

    def test_unported_payloads_raise(self):
        """Every payload is ported now: the grids (item 7) and raw-MV
        (item 8) payloads decide as the JAX detector does; what still
        raises is an overflowed raw-MV frame, as it does there."""
        det = MVClusterDetector(640, 480, Config(scan_backend="torch"))
        jax_det = JaxDetector(640, 480, JaxConfig(scan_backend="xla"))
        rng = np.random.default_rng(8)
        grids = rng.integers(0, 4, size=(20, det.geom.gh, det.geom.gw),
                             dtype=np.uint8)
        np.testing.assert_array_equal(det.scan_votes_async(grids)(),
                                      jax_det.scan_votes(grids))
        mvs = rng.integers(0, 640, size=(20, 64, 4)).astype(np.int16)
        mvs[:, :32, :2] = rng.integers(100, 140, size=(20, 32, 2))
        mvs[..., 2:] = mvs[..., :2] - 4
        counts = rng.integers(0, 65, size=20).astype(np.int32)
        np.testing.assert_array_equal(det.scan_raw_mvs_async(mvs, counts)(),
                                      jax_det.scan_raw_mvs(mvs, counts))
        for d in (det, jax_det):
            with pytest.raises(ValueError, match="overflowed"):
                d.scan_raw_mvs_async(mvs[:1], -counts[:1] - 1)

    def test_words_shape_checked(self):
        det = MVClusterDetector(640, 480, Config(scan_backend="torch"))
        with pytest.raises(ValueError):
            det.scan_words(np.zeros((2, 3), np.int32))

    def test_torch_backend_stays_on_cpu(self):
        det = MVClusterDetector(640, 480, Config(scan_backend="torch"),
                                device="cuda:1")
        assert det.device == torch.device("cpu")
