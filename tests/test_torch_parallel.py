"""mvtrim_tpu_torch's mesh and sharded steps vs the JAX package's.

The twins of tests/test_parallel.py's TestMesh, TestShardedScan and
TestDistributed, on the port's CPU shards (``build_mesh(..., device=
'cpu')``), and each port step held against its JAX step on the suite's
8-device virtual CPU mesh: the same seeded numpy inputs, compared
exactly (decisions are integers).  The JAX steps take padded grids and
luma and flattened bit lanes; the port's take the unpadded payloads.
"""

import numpy as np
import jax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.core.oracle import count_clusters_batch
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.ops.cluster import packed_geometry
from mvtrim_tpu.ops.sad import pad_luma, sad_threshold_sum
from mvtrim_tpu.parallel import mesh as jax_mesh
from mvtrim_tpu_torch.core import Config, GridGeometry
from mvtrim_tpu_torch.parallel import distributed
from mvtrim_tpu_torch.parallel import mesh as torch_mesh
from mvtrim_tpu_torch.parallel.mesh import (build_mesh, shard_votes,
                                            sharded_scan_step,
                                            stream_device_assignment)

CFG = Config()
GEOM = GridGeometry.build(256, 192, CFG)
JGEOM = JaxGeometry.build(256, 192, JaxConfig())


def expected_motion(votes, vec_need):
    counts = count_clusters_batch(votes, vectors_needed=vec_need,
                                  y_min=GEOM.y_min, y_max=GEOM.y_max)
    return counts >= max(1, CFG.clusters_needed)


def padded_votes(votes):
    out = np.zeros((len(votes), JGEOM.padded_gh, JGEOM.padded_gw), np.uint8)
    out[:, :GEOM.gh, :GEOM.gw] = votes
    return out


class TestMesh:
    @pytest.mark.parametrize("n,sweep", [(8, 1), (8, 2), (4, 2), (2, 1)])
    def test_mesh_shapes(self, n, sweep):
        mesh = build_mesh(n, sweep=sweep, device="cpu")
        assert mesh.shape["data"] * mesh.shape["sweep"] == n
        assert mesh.shape["sweep"] == sweep
        assert mesh.devices.shape == (n // sweep, sweep)
        assert all(d == torch.device("cpu") for d in mesh.devices.ravel())

    def test_stream_assignment_round_robin(self):
        mesh = build_mesh(4, device="cpu")
        assert stream_device_assignment(6, mesh) == [0, 1, 2, 3, 0, 1]

    @pytest.fixture
    def one_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: "NVIDIA H100 80GB HBM3")

    def test_oversized_mesh_fails_loudly(self, one_card):
        """More cards requested than the host has must raise with the
        inventory, never silently scan on host CPUs."""
        with pytest.raises(RuntimeError,
                           match="2-device mesh.*only 1 CUDA.*H100"):
            build_mesh(2, device="cuda")

    def test_fitting_mesh_takes_the_cards(self, one_card):
        assert build_mesh(device="cuda").devices.tolist() == \
            [[torch.device("cuda", 0)]]

    def test_indivisible_sweep_raises(self):
        with pytest.raises(ValueError, match="not divisible by sweep"):
            build_mesh(8, sweep=3, device="cpu")

    def test_backend_picks_the_device(self, monkeypatch):
        monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
        assert build_mesh(3).devices.size == 3
        assert build_mesh().devices[0, 0].type == "cpu"
        monkeypatch.setenv("MVT_SCAN_BACKEND", "auto")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="MVT_SCAN_BACKEND=torch"):
            build_mesh(2)

    def test_process_mesh_is_this_ranks_device(self, monkeypatch):
        assert torch_mesh.build_process_mesh("cpu").devices[0, 0] == \
            torch.device("cpu")
        monkeypatch.setenv("LOCAL_RANK", "5")
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        assert torch_mesh.build_process_mesh("cuda").devices[0, 0] == \
            torch.device("cuda", 1)

    @pytest.mark.parametrize("n,parts", [(0, 3), (7, 3), (8, 8), (3, 8),
                                         (256, 8)])
    def test_split_is_exact(self, n, parts):
        spans = torch_mesh.split(n, parts)
        assert len(spans) == parts and spans[0][0] == 0
        assert spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        sizes = [hi - lo for lo, hi in spans]
        assert max(sizes) - min(sizes) <= 1

    def test_shard_votes_covers_the_batch(self, rng):
        votes = rng.integers(0, 5, size=(10, 4, 6), dtype=np.uint8)
        shards = shard_votes(votes, build_mesh(4, device="cpu"))
        assert [len(s) for s in shards] == [3, 3, 2, 2]
        np.testing.assert_array_equal(torch.cat(shards).numpy(), votes)


class TestShardedScan:
    @pytest.mark.parametrize("sweep", [1, 2, 4])
    def test_scan_step_matches_jax_and_oracle(self, rng, sweep):
        b = 16 * (8 // sweep)
        votes = rng.integers(0, 5, size=(b, GEOM.gh, GEOM.gw),
                             dtype=np.uint8)
        vec_needs = np.arange(1, sweep + 1, dtype=np.int32)
        motion, counts = (t.numpy() for t in sharded_scan_step(
            GEOM, CFG, build_mesh(8, sweep=sweep, device="cpu"))(
                votes, vec_needs))
        jmesh = jax_mesh.build_mesh(8, sweep=sweep)
        jmotion, jcounts = jax_mesh.sharded_scan_step(JGEOM, JaxConfig(),
                                                      jmesh)(
            jax_mesh.shard_votes(padded_votes(votes), jmesh),
            jax.device_put(vec_needs, NamedSharding(jmesh, P("sweep"))))
        np.testing.assert_array_equal(motion, np.asarray(jmotion))
        np.testing.assert_array_equal(counts, np.asarray(jcounts))
        for k, vn in enumerate(vec_needs):
            np.testing.assert_array_equal(motion[:, k],
                                          expected_motion(votes, int(vn)))

    @pytest.mark.parametrize("sweep", [1, 2, 4])
    def test_config_sweep_matches_jax(self, rng, sweep):
        """tune --mesh's form: (vectors, clusters) pairs over 'sweep'."""
        votes = rng.integers(0, 5, size=(32, GEOM.gh, GEOM.gw),
                             dtype=np.uint8)
        vec = np.array([1, 2, 3, 1], np.int32)
        clu = np.array([1, 1, 2, 4], np.int32)
        motion, _ = sharded_scan_step(
            GEOM, CFG, build_mesh(8, sweep=sweep, device="cpu"),
            sweep_clusters=True)(votes, vec, clu)
        motion = motion.numpy()
        jmesh = jax_mesh.build_mesh(8, sweep=sweep)
        sh = NamedSharding(jmesh, P("sweep"))
        jmotion, _ = jax_mesh.sharded_scan_step(
            JGEOM, JaxConfig(), jmesh, sweep_clusters=True)(
                jax_mesh.shard_votes(padded_votes(votes), jmesh),
                jax.device_put(vec, sh), jax.device_put(clu, sh))
        np.testing.assert_array_equal(motion, np.asarray(jmotion))

    def test_data_shard_independence(self, rng):
        """The same frames give the same decisions whatever the mesh size,
        uneven splits included."""
        votes = rng.integers(0, 5, size=(37, GEOM.gh, GEOM.gw),
                             dtype=np.uint8)
        vec = np.array([2], dtype=np.int32)
        results = [[t.numpy() for t in sharded_scan_step(
            GEOM, CFG, build_mesh(n, device="cpu"))(votes, vec)]
            for n in (1, 2, 8)]
        for m, c in results[1:]:
            np.testing.assert_array_equal(m, results[0][0])
            np.testing.assert_array_equal(c, results[0][1])

    @pytest.mark.parametrize("n_frames", [64, 61])
    def test_bits_step_matches_jax(self, rng, n_frames):
        gwb, used, lanes = packed_geometry(JGEOM)
        active = rng.random((n_frames, GEOM.gh, GEOM.gw)) < 0.3
        bits = np.packbits(active, axis=2, bitorder="little")
        motion, count = torch_mesh.sharded_bits_scan_step(
            GEOM, CFG, build_mesh(8, device="cpu"))(bits)
        # the JAX step takes flattened lanes, padded to the data axis
        flat = np.zeros((64, lanes), np.uint8)
        flat[:n_frames, :used] = bits.reshape(n_frames, used)
        jmesh = jax_mesh.build_mesh(8)
        jmotion, jcount = jax_mesh.sharded_bits_scan_step(
            JGEOM, JaxConfig(), jmesh)(jax.device_put(
                flat, NamedSharding(jmesh, P("data", None))))
        np.testing.assert_array_equal(motion,
                                      np.asarray(jmotion)[:n_frames])
        assert count == int(motion.sum())
        if n_frames == 64:
            assert count == int(jcount)
        np.testing.assert_array_equal(
            motion, expected_motion(active.astype(np.uint8), 1))

    @staticmethod
    def _luma(rng, n, w=200, h=104):
        """[1 + n, h, w] luma, row 0 the predecessor: noise with some
        frames static, some shifted, partial edge blocks on both axes."""
        luma = rng.integers(0, 256, size=(1 + n, h, w), dtype=np.uint8)
        luma[3] = luma[2]
        luma[5, :40] = luma[4, :40]
        luma[7] = np.clip(luma[6].astype(np.int16) + 3, 0, 255)
        return luma

    @pytest.mark.parametrize("data", [1, 2, 4, 8])
    def test_sad_scan_step_matches_jax(self, rng, data):
        """Shard d's carry is the frame before its first row; valid masks
        chunk starts (tests/test_parallel-style exactness)."""
        geom = GridGeometry.build(200, 104, CFG)
        jgeom = JaxGeometry.build(200, 104, JaxConfig())
        n = 16
        luma = self._luma(rng, n)
        luma[1 + 8] = 255 - luma[8]          # a big jump at a shard edge
        valid = np.ones((n,), bool)
        valid[[0, 5, 11]] = False
        motion, count = torch_mesh.sharded_sad_scan_step(
            geom, CFG, build_mesh(data, device="cpu"))(luma, valid)
        rows = n // data
        padded = pad_luma(luma, jgeom, 16)
        carries = padded[[d * rows for d in range(data)]]
        jmesh = jax_mesh.build_mesh(data)
        sh3 = NamedSharding(jmesh, P("data", None, None))
        jmotion, jcount = jax_mesh.sharded_sad_scan_step(
            jgeom, JaxConfig(), jmesh)(
                jax.device_put(carries, sh3), jax.device_put(padded[1:], sh3),
                jax.device_put(valid, NamedSharding(jmesh, P("data"))))
        np.testing.assert_array_equal(motion, np.asarray(jmotion))
        assert count == int(jcount) and motion.any()
        assert not motion[~valid].any()

    @pytest.mark.parametrize("data,sweep", [(1, 1), (2, 2), (4, 2), (2, 4)])
    def test_sad_sweep_step_matches_jax(self, rng, data, sweep):
        geom = GridGeometry.build(200, 104, CFG)
        jgeom = JaxGeometry.build(200, 104, JaxConfig())
        n = 8 * data
        luma = self._luma(rng, n)
        bounds = np.array([sad_threshold_sum(t, 16) for t in
                           (0.5, 4.0, 12.0, 85.0)], np.int32)
        clus = np.array([1, 2, 0, 1], np.int32)
        motion = torch_mesh.sharded_sad_sweep_step(
            geom, CFG, build_mesh(data * sweep, sweep=sweep, device="cpu"))(
                luma, bounds, clus).numpy()
        rows = n // data
        padded = pad_luma(luma, jgeom, 16)
        jmesh = jax_mesh.build_mesh(data * sweep, sweep=sweep)
        sh3 = NamedSharding(jmesh, P("data", None, None))
        shk = NamedSharding(jmesh, P("sweep"))
        jmotion = jax_mesh.sharded_sad_sweep_step(jgeom, JaxConfig(), jmesh)(
            jax.device_put(padded[[d * rows for d in range(data)]], sh3),
            jax.device_put(padded[1:], sh3), jax.device_put(bounds, shk),
            jax.device_put(clus, shk))
        np.testing.assert_array_equal(motion, np.asarray(jmotion))
        assert motion.any() and not motion.all()


class TestDistributed:
    @pytest.fixture(autouse=True)
    def no_launcher(self, monkeypatch):
        for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                  "LOCAL_RANK"):
            monkeypatch.delenv(k, raising=False)

    def test_single_process_noop(self):
        assert distributed.initialize() is False
        assert distributed.world() == (1, 0)
        assert distributed.local_rank() == 0

    def test_empty_address_is_unset(self, monkeypatch):
        """An EMPTY MASTER_ADDR (an unfilled env template) means single
        process, not a group that waits for a rendezvous at startup."""
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "")
        monkeypatch.setenv("MASTER_PORT", "29500")
        assert distributed.initialize() is False

    def test_world_of_one_is_single_process(self, monkeypatch):
        monkeypatch.setenv("WORLD_SIZE", "1")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "29500")
        assert distributed.initialize() is False

    def test_collectives_outside_a_group(self):
        assert distributed.allgather_ints([3, 4]).tolist() == [[3, 4]]
        assert distributed.allreduce_sum(5) == 5
        x = np.array([1 / 3, 0.1], np.float64)
        g = distributed.allgather_f64(x)
        assert g.shape == (1, 2) and g.tobytes() == x.tobytes()
