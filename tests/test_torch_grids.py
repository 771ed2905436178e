"""mvtrim_tpu_torch vote-level cluster op and the grids payload vs JAX.

Seeded numpy vote grids go through the port's plain PyTorch build
(``cluster_map_counts_plain`` / ``cluster_map_op`` on CPU tensors), the
JAX XLA build, the JAX Pallas kernel in interpret mode (on ``pad_votes``
input, as the JAX package feeds it) and the NumPy oracle.  Everything is
integer math, so the tolerance is exact equality.  The CUDA kernel itself
is checked by the ``cuda``-marked test, which runs only where a card is
present (``python -m pytest -m cuda tests/test_torch_grids.py``).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mvtrim_tpu.core import oracle
from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.models.mv_detector import MVClusterDetector as JaxDetector
from mvtrim_tpu.ops import cluster as jax_cluster
from mvtrim_tpu_torch.core import Config, GridGeometry
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.ops import cluster as torch_cluster

GEOMETRIES = [  # (width, height, vertical_mask)
    (640, 480, 0.05),     # gw=40, gh=30
    (360, 240, 0.0),      # margin 0: off-grid rows are neighbours
    (200, 144, 0.05),     # gw=13 < 32
    (320, 16, 0.0),       # gh=1
    (96, 32, 0.0),        # gh=2, gw=6
]
VECTORS_NEEDED = (0, 1, 2, 5, 255)


def jx(geom):
    """The JAX package's GridGeometry with the fields of a port one."""
    return JaxGeometry(**dataclasses.asdict(geom))


def votes(seed, b, geom, high=4):
    """uint8 [b, gh, gw] votes in [0, high), plus cells at 254/255 so the
    top of the uint8 range is reached."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, high, size=(b, geom.gh, geom.gw)).astype(np.uint8)
    v[rng.random(v.shape) < 0.05] = 255
    v[rng.random(v.shape) < 0.05] = 254
    return v


def case(dims_vm, b):
    width, height, vm = dims_vm
    cfg = Config(vertical_mask=vm)
    geom = GridGeometry.build(width, height, cfg)
    return cfg, geom, votes(width * 31 + height + b, b, geom)


@pytest.mark.parametrize("vn", VECTORS_NEEDED)
@pytest.mark.parametrize("dims_vm", GEOMETRIES)
def test_plain_matches_xla_and_oracle(dims_vm, vn):
    cfg, geom, v = case(dims_vm, 5)
    xla_counts, xla_motion = jax_cluster.make_cluster_op_xla(
        jx(geom), vn, cfg.clusters_needed)(jax_cluster.pad_votes(
            jnp.asarray(v), jx(geom)))
    expect = oracle.count_clusters_batch(v, vectors_needed=vn,
                                         y_min=geom.y_min, y_max=geom.y_max)
    np.testing.assert_array_equal(np.asarray(xla_counts), expect)
    for dtype in (torch.uint8, torch.int32):
        t = torch.from_numpy(v).to(dtype)
        plain = torch_cluster.cluster_map_counts_plain(t, geom, vn)
        counts, motion = torch_cluster.cluster_map_op(
            t, geom, vn, cfg.clusters_needed)
        assert plain.dtype == counts.dtype == torch.int32
        np.testing.assert_array_equal(plain.numpy(), expect)
        np.testing.assert_array_equal(counts.numpy(), expect)
        np.testing.assert_array_equal(motion.numpy(),
                                      np.asarray(xla_motion))


@pytest.mark.parametrize("dims_vm", GEOMETRIES)
def test_matches_pallas_interpret(dims_vm):
    """The TPU kernel this op replaces (make_cluster_op_pallas), in
    interpret mode on zero-padded [B, GH_p, GW_p] input."""
    cfg, geom, v = case(dims_vm, 4)
    for vn in (0, 2):
        op = jax_cluster.make_cluster_op_pallas(
            jx(geom), vn, cfg.clusters_needed, block_b=4, interpret=True)
        p_counts, p_motion = op(jax_cluster.pad_votes(jnp.asarray(v),
                                                      jx(geom)))
        counts, motion = torch_cluster.cluster_map_op(
            torch.from_numpy(v), geom, vn, cfg.clusters_needed)
        np.testing.assert_array_equal(np.asarray(p_counts), counts.numpy())
        np.testing.assert_array_equal(np.asarray(p_motion), motion.numpy())


@pytest.mark.parametrize("dims_vm", GEOMETRIES)
def test_int32_grid_with_a_large_threshold(dims_vm):
    """The SAD path's use: int32 block sums against a bound far above
    uint8, as the JAX cluster_counts_traced takes it."""
    cfg, geom, _ = case(dims_vm, 3)
    rng = np.random.default_rng(7)
    grid = rng.integers(0, 6000, size=(3, geom.gh, geom.gw)).astype(np.int32)
    for bound in (0, 3071, 3072, 3073):
        expect = np.asarray(jax_cluster.cluster_counts_traced(
            jnp.asarray(grid), jx(geom), jnp.int32(bound)))
        counts, _ = torch_cluster.cluster_map_op(
            torch.from_numpy(grid), geom, bound, cfg.clusters_needed)
        np.testing.assert_array_equal(counts.numpy(), expect)
        np.testing.assert_array_equal(
            counts.numpy(), oracle.count_clusters_batch(
                grid, vectors_needed=bound, y_min=geom.y_min,
                y_max=geom.y_max))


def test_off_grid_neighbours_are_zero_votes_at_threshold_zero():
    """At threshold 0 a zero-filled off-grid neighbour is active, so a
    margin-0 edge row counts with no neighbour inside the grid at all
    (the word-domain rule "off grid => inactive" would give 0 here)."""
    geom = GridGeometry.build(96, 16, Config(vertical_mask=0.0))  # 6x1
    v = torch.zeros((1, geom.gh, geom.gw), dtype=torch.uint8)
    counts, _ = torch_cluster.cluster_map_op(v, geom, 0, 1)
    assert counts.tolist() == [geom.gw - 2] == oracle.count_clusters_batch(
        v.numpy(), vectors_needed=0, y_min=0, y_max=1).tolist()
    assert torch_cluster.cluster_map_op(v, geom, 1, 1)[0].tolist() == [0]


class TestWrapper:
    GEOM = GridGeometry.build(640, 480, Config())

    def test_cpu_tensor_runs_plain_and_counts_no_launch(self):
        before = torch_cluster.cluster_map_op.launches
        counts, motion = torch_cluster.cluster_map_op(
            torch.zeros((3, self.GEOM.gh, self.GEOM.gw), dtype=torch.uint8),
            self.GEOM, 2, 2)
        assert torch_cluster.cluster_map_op.launches == before
        assert counts.tolist() == [0, 0, 0]
        assert motion.dtype == torch.bool and not motion.any()

    def test_empty_batch(self):
        counts, motion = torch_cluster.cluster_map_op(
            torch.zeros((0, self.GEOM.gh, self.GEOM.gw), dtype=torch.int32),
            self.GEOM, 1, 2)
        assert counts.shape == motion.shape == (0,)

    @pytest.mark.parametrize("bad", ["dtype", "shape", "stride", "device"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        g = self.GEOM
        v = torch.zeros((4, g.gh, g.gw), dtype=torch.uint8)
        if bad == "dtype":
            v = v.to(torch.int64)
        elif bad == "shape":
            v = torch.zeros((4, g.gh, g.gw + 1), dtype=torch.uint8)
        elif bad == "stride":
            v = torch.zeros((g.gw, g.gh, 4), dtype=torch.uint8).permute(
                2, 1, 0)
        else:
            v = v.to("meta")
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            torch_cluster.cluster_map_op(v, g, 2, 2)


@pytest.mark.parametrize("dims", [(640, 480), (1920, 1080)])
@pytest.mark.parametrize("vn", VECTORS_NEEDED)
def test_scan_votes_matches_jax_detector(dims, vn):
    """device_batch 16 < 40 frames: several dispatches per scan; the
    oracle backend passes through to count_clusters_batch."""
    port = MVClusterDetector(*dims, Config(scan_backend="torch",
                                           device_batch=16,
                                           vectors_needed=vn))
    jax_det = JaxDetector(*dims, JaxConfig(scan_backend="xla",
                                           device_batch=16,
                                           vectors_needed=vn))
    ref = MVClusterDetector(*dims, Config(scan_backend="oracle",
                                          vectors_needed=vn))
    grids = votes(dims[0] + vn, 40, port.geom)
    expect = jax_det.scan_votes(grids)
    assert expect.shape == (40,) and expect.dtype == bool
    np.testing.assert_array_equal(port.scan_votes(grids), expect)
    np.testing.assert_array_equal(ref.scan_votes(grids), expect)
    assert port.scan_votes(grids[:0]).shape == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("dims_vm", GEOMETRIES + [(1920, 1080, 0.05),
                                                  (3840, 2160, 0.05)])
def test_cuda_kernel_matches_plain(dims_vm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_grids.py)")
    cfg, geom, v = case(dims_vm, 777)
    for vn in VECTORS_NEEDED:
        for dtype in (torch.uint8, torch.int32):
            t = torch.from_numpy(v).to(dtype)
            before = torch_cluster.cluster_map_op.launches
            counts, motion = torch_cluster.cluster_map_op(
                t.cuda(), geom, vn, cfg.clusters_needed)
            torch.cuda.synchronize()
            assert torch_cluster.cluster_map_op.launches == before + 1
            plain = torch_cluster.cluster_map_counts_plain(t, geom, vn)
            np.testing.assert_array_equal(counts.cpu().numpy(),
                                          plain.numpy())
            np.testing.assert_array_equal(
                motion.cpu().numpy(), plain.numpy() >= max(
                    1, cfg.clusters_needed))
