"""mvtrim_tpu_torch fused raw-MV op (``ops/mv_vote.py``) vs JAX.

Seeded numpy MV fields (int16 [B, M, 4], the host payload) go through the
port's plain PyTorch build (``mv_cluster_op`` on CPU tensors), the JAX XLA
op, the JAX Pallas kernel in interpret mode (both of its bodies: the whole
list in one block, and the ragged chunk grid at a small ``m_chunk``), the
JAX package's NumPy restatement ``host_expected_clusters`` and the oracle.  Everything is
integer math, so the tolerance is exact equality.  The CUDA kernel is
checked by the ``cuda``-marked tests, which run only where a card is
present (``python -m pytest -m cuda tests/test_torch_mv_vote.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.models.mv_detector import MVClusterDetector as JaxDetector
from mvtrim_tpu.ops import mv_vote as jax_mv
from mvtrim_tpu_torch.core import Config, GridGeometry, oracle
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.ops import mv_vote as torch_mv

GEOMETRIES = [  # (width, height, vertical_mask)
    (640, 480, 0.05),     # gw=40, gh=30
    (360, 240, 0.0),      # margin 0: off-grid rows are neighbours
    (200, 144, 0.05),     # gw=13
]
VECTORS_NEEDED = (0, 1, 2, 255)
SHIFT = 4


def geoms(dims_vm):
    w, h, vm = dims_vm
    return (JaxGeometry.build(w, h, JaxConfig(vertical_mask=vm)),
            GridGeometry.build(w, h, Config(vertical_mask=vm)))


def random_mvs(seed, counts, m, width, height):
    """int16 [B, m, 4]: frame b holds counts[b] MVs, dst over the frame
    and 32 pixels past each edge (negative dst included), displacements
    up to 8; the first half of each list lands in one 64x48 box, so
    cells collect several votes and clusters form."""
    rng = np.random.default_rng(seed)
    b = len(counts)
    mvs = np.zeros((b, m, 4), np.int16)
    mvs[..., 0] = rng.integers(-32, width + 32, size=(b, m))
    mvs[..., 1] = rng.integers(-32, height + 32, size=(b, m))
    box = m // 2
    mvs[:, :box, 0] = rng.integers(width // 4, width // 4 + 64, size=(b, box))
    mvs[:, :box, 1] = rng.integers(height // 4, height // 4 + 48,
                                   size=(b, box))
    mvs[..., 2:] = mvs[..., :2] - rng.integers(-8, 9, size=(b, m, 2))
    for i, c in enumerate(counts):
        mvs[i, c:] = rng.integers(-50, 50, size=(m - c, 4))  # past count
    return mvs


def extreme_frame(m, width, height):
    """One frame whose magnitudes wrap int32: int16-extreme MVs at dst =
    32767, src = -32768 on both axes, and a cluster of MVs in the grid
    with src = -32768 on both axes, whose |d|^2 sums pass 2^31 and wrap
    negative (the reference's `int` drops them at any threshold >= 0),
    beside a cluster of ordinary MVs."""
    mvs = np.zeros((1, m, 4), np.int16)
    mvs[0, :4] = (32767, 32767, -32768, -32768)
    ys, xs = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    cells = np.stack([xs.ravel(), ys.ravel()], 1)
    for j, (cx, cy) in enumerate(cells):
        base = 4 + 4 * j
        dst = ((cx + 3) << SHIFT, (cy + 3) << SHIFT)
        mvs[0, base:base + 2] = (dst[0], dst[1], -32768, -32768)
        mvs[0, base + 2:base + 4] = (dst[0] + 20 * 16, dst[1], 0, 0)
    assert width > 24 * 16 and height > 8 * 16
    return mvs, np.array([4 + 4 * len(cells)], np.int32)


def hot_cell_mvs(counts, m, geom, cells):
    """int16 [B, m, 4]: frame b's MVs in one cell (cells = 1), or
    alternating between two neighbouring cells (cells = 2), near the
    middle of the grid, each with |d|^2 = 25 or 50."""
    b = len(counts)
    mvs = np.zeros((b, m, 4), np.int16)
    k = np.arange(m)
    cx, cy = geom.gw // 2, (geom.y_min + geom.y_max) // 2
    mvs[..., 0] = ((cx + k % cells) << SHIFT) + k % 16
    mvs[..., 1] = (cy << SHIFT) + (k // 16) % 16
    mvs[..., 2] = mvs[..., 0] - 5
    mvs[..., 3] = mvs[..., 1] - 5 * (k % 2)
    return mvs


@pytest.mark.parametrize("cells", [1, 2])
def test_hot_cells_match_xla(cells):
    """The hot-cell frames of the cuda test, on the CPU: the port's plain
    build equals the JAX XLA op (one lone cell never clusters; two
    neighbouring cells do)."""
    jg, tg = geoms(GEOMETRIES[0])
    counts = np.array([300, 150, 1, 0, 17], np.int32)
    mvs = hot_cell_mvs(counts, 300, tg, cells)
    for vn in (0, 1, 2, 150):
        xla = jax_mv.make_mv_cluster_op_xla(
            jg, threshold_sq=16.0, block_shift=SHIFT, vectors_needed=vn,
            clusters_needed=1)(*jax_fields(mvs), jnp.asarray(counts))
        got = port(mvs, counts, tg, 16.0, vn)
        assert_equal(got, xla)
        if vn == 1:
            assert got[0].tolist()[0] == (2 if cells == 2 else 0)


def jax_fields(mvs):
    f = mvs.astype(np.int32)
    return tuple(jnp.asarray(f[..., i]) for i in range(4))


def port(mvs, counts, geom, thr, vn, cn=1):
    return torch_mv.mv_cluster_op(
        torch.from_numpy(mvs), torch.from_numpy(counts), geom,
        torch_mv.threshold_bound(thr), vn, cn, SHIFT)


def assert_equal(got, want):
    counts, motion = got
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(motion.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("vn", VECTORS_NEEDED)
@pytest.mark.parametrize("dims_vm", GEOMETRIES)
def test_plain_matches_xla_and_host_expected(dims_vm, vn):
    jg, tg = geoms(dims_vm)
    m = 300  # not a multiple of anything the TPU kernel chunks by
    counts = np.array([0, 1, 17, 150, 299, 300, 0, 64], np.int32)
    mvs = random_mvs(dims_vm[0] + vn, counts, m, *dims_vm[:2])
    for thr in (16.0, 16.5, 0.0, -3.0):
        xla = jax_mv.make_mv_cluster_op_xla(
            jg, threshold_sq=thr, block_shift=SHIFT, vectors_needed=vn,
            clusters_needed=2)(*jax_fields(mvs), jnp.asarray(counts))
        got = port(mvs, counts, tg, thr, vn, 2)
        assert_equal(got, xla)
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
        # the JAX package's NumPy restatement agrees too
        f = mvs.astype(np.int32)
        _, expect = jax_mv.host_expected_clusters(
            f[..., 0], f[..., 1], f[..., 2], f[..., 3], counts, jg,
            threshold_sq=thr, block_shift=SHIFT, vectors_needed=vn)
        np.testing.assert_array_equal(got[0].numpy(), expect)


@pytest.mark.parametrize("dims_vm", GEOMETRIES)
def test_plain_matches_the_oracle_frame_by_frame(dims_vm):
    jg, tg = geoms(dims_vm)
    counts = np.array([0, 1, 40, 200], np.int32)
    mvs = random_mvs(7, counts, 200, *dims_vm[:2])
    for vn in (0, 2):
        got = port(mvs, counts, tg, 16.0, vn, 1)[1].numpy()
        expect = [oracle.check_frame(
            mvs[i, :counts[i]], tg.gw, tg.gh, threshold_sq=16.0,
            block_shift=SHIFT, y_min=tg.y_min, y_max=tg.y_max,
            vectors_needed=vn, clusters_needed=1) for i in range(4)]
        np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("vn", (0, 2))
def test_matches_pallas_whole_list(vn):
    """make_kernel(F): m <= m_chunk, B = 5 not a multiple of the step."""
    jg, tg = geoms(GEOMETRIES[0])
    counts = np.array([0, 1, 100, 255, 256], np.int32)
    mvs = random_mvs(11 + vn, counts, 256, 640, 480)
    op = jax_mv.make_mv_cluster_op_pallas(
        jg, threshold_sq=16.0, block_shift=SHIFT, vectors_needed=vn,
        clusters_needed=1, interpret=True, m_chunk=256, frames_per_step=2)
    assert_equal(port(mvs, counts, tg, 16.0, vn),
                 op(*jax_fields(mvs), jnp.asarray(counts)))


@pytest.mark.parametrize("vn", (0, 1))
def test_matches_pallas_ragged_chunks(vn):
    """make_ragged_kernel: m = 700 > m_chunk = 256, not a multiple of it
    (padded to 768), counts at 0, 1, the chunk boundaries and capacity,
    B = 7 against 3 frames a step."""
    jg, tg = geoms(GEOMETRIES[0])
    counts = np.array([0, 1, 255, 256, 257, 512, 700], np.int32)
    mvs = random_mvs(23 + vn, counts, 700, 640, 480)
    op = jax_mv.make_mv_cluster_op_pallas(
        jg, threshold_sq=16.0, block_shift=SHIFT, vectors_needed=vn,
        clusters_needed=1, interpret=True, m_chunk=256, frames_per_step=3)
    assert_equal(port(mvs, counts, tg, 16.0, vn),
                 op(*jax_fields(mvs), jnp.asarray(counts)))


@pytest.mark.parametrize("vn", VECTORS_NEEDED)
def test_int16_extremes_wrap_like_the_reference(vn):
    """|dx| reaches 65,535: the magnitude wraps to int32 in the port, the
    JAX ops and the oracle alike (the wrapped cluster drops out)."""
    jg, tg = geoms(GEOMETRIES[0])
    mvs, counts = extreme_frame(64, 640, 480)
    f = mvs.astype(np.int64)
    mag = (f[0, :4, 0] - f[0, :4, 2]) ** 2 * 2
    assert (mag > 2 ** 32).all()  # the wrap is exercised
    got = port(mvs, counts, tg, 16.0, vn)
    xla = jax_mv.make_mv_cluster_op_xla(
        jg, threshold_sq=16.0, block_shift=SHIFT, vectors_needed=vn,
        clusters_needed=1)(*jax_fields(mvs), jnp.asarray(counts))
    assert_equal(got, xla)
    pallas = jax_mv.make_mv_cluster_op_pallas(
        jg, threshold_sq=16.0, block_shift=SHIFT, vectors_needed=vn,
        clusters_needed=1, interpret=True)(*jax_fields(mvs),
                                           jnp.asarray(counts))
    assert_equal(got, pallas)
    assert got[1].tolist() == [oracle.check_frame(
        mvs[0, :counts[0]], tg.gw, tg.gh, threshold_sq=16.0,
        block_shift=SHIFT, y_min=tg.y_min, y_max=tg.y_max,
        vectors_needed=vn, clusters_needed=1)]
    # only the two ordinary MVs of each of the nine cells vote; without
    # the wrap the in-grid src=-32768 MVs would vote too
    votes = torch_mv.mv_votes_plain(torch.from_numpy(mvs),
                                    torch.from_numpy(counts), tg, 16, SHIFT)
    assert int(votes.sum()) == 18


def test_negative_dst_floors_off_the_grid():
    """dst -1 >> 4 is -1 (arithmetic), not 0: the MV is dropped."""
    _, tg = geoms(GEOMETRIES[1])  # margin 0: row 0 is in the window
    mvs = np.zeros((1, 8, 4), np.int16)
    mvs[0, :4] = [(-1, 5, -9, 5), (5, -1, 5, -9), (-16, -16, 0, 0),
                  (-17, 3, 0, 3)]
    mvs[0, 4:] = [(1, 1, 9, 9), (17, 1, 25, 9), (1, 17, 9, 25),
                  (17, 17, 25, 25)]
    counts = np.array([8], np.int32)
    votes = torch_mv.mv_votes_plain(torch.from_numpy(mvs),
                                    torch.from_numpy(counts), tg, 16, SHIFT)
    assert int(votes.sum()) == 4 and int(votes[0, 0, 0]) == 1
    assert votes[0, :2, :2].tolist() == [[1, 1], [1, 1]]


def test_mv_less_frames_decide_false_at_vectors_needed_zero():
    _, tg = geoms(GEOMETRIES[0])
    mvs = np.zeros((3, 16, 4), np.int16)
    counts = np.array([0, 0, 16], np.int32)
    c, m = port(mvs, counts, tg, 16.0, 0)
    assert (c.numpy() > 0).all()  # zero votes pass >= 0 everywhere
    assert m.tolist() == [False, False, True]


def test_vectors_needed_256_wraps_to_zero_through_config():
    cfg = Config(scan_backend="torch", vectors_needed=256)
    assert cfg.vectors_needed == 0
    det = MVClusterDetector(640, 480, cfg)
    jdet = JaxDetector(640, 480, JaxConfig(scan_backend="xla",
                                           vectors_needed=256))
    counts = np.array([0, 5, 100], np.int32)
    mvs = random_mvs(3, counts, 128, 640, 480)
    np.testing.assert_array_equal(det.scan_raw_mvs(mvs, counts),
                                  jdet.scan_raw_mvs(mvs, counts))


class TestDetector:
    @pytest.mark.parametrize("backend", ["torch", "oracle"])
    def test_scan_raw_mvs_matches_jax(self, backend):
        """device_batch 8 < 20 frames: several dispatches per scan."""
        counts = np.array([0, 1, 40, 100, 128] * 4, np.int32)
        mvs = random_mvs(5, counts, 128, 640, 480)
        ours = MVClusterDetector(640, 480, Config(scan_backend=backend,
                                                  device_batch=8))
        theirs = JaxDetector(640, 480, JaxConfig(scan_backend="xla",
                                                 device_batch=8))
        expect = theirs.scan_raw_mvs(mvs, counts)
        assert expect.any() and not expect.all()
        np.testing.assert_array_equal(ours.scan_raw_mvs(mvs, counts), expect)
        assert ours.scan_raw_mvs(mvs[:0], counts[:0]).shape == (0,)

    def test_overflow_is_refused(self):
        det = MVClusterDetector(640, 480, Config(scan_backend="torch"))
        counts = np.array([3, -9000, -8500], np.int32)
        with pytest.raises(ValueError, match="overflowed the MV capacity"):
            det.scan_raw_mvs_async(np.zeros((3, 8, 4), np.int16), counts)

    @pytest.mark.parametrize("n,db,buckets", [
        (1, 2048, [1]), (300, 2048, [300]), (700, 512, [512, 188]),
        (5, 4, [4, 1]), (1025, 4096, [1025])])
    def test_power_of_two_buckets(self, monkeypatch, n, db, buckets):
        """Each dispatch sends exactly its frames, at most device_batch:
        no power-of-two bucket, no padding frame."""
        det = MVClusterDetector(640, 480, Config(scan_backend="torch",
                                                 device_batch=db))
        seen = []
        real = torch_mv.mv_cluster_op

        def spy(mvs, counts, *args, **kw):
            seen.append(mvs.shape[0])
            return real(mvs, counts, *args, **kw)

        monkeypatch.setattr(torch_mv, "mv_cluster_op", spy)
        counts = np.full((n,), 3, np.int32)
        motion = det.scan_raw_mvs(random_mvs(n, counts, 8, 640, 480),
                                  counts)
        assert seen == buckets and motion.shape == (n,)


class TestWrapper:
    GEOM = GridGeometry.build(640, 480, Config())

    def test_cpu_tensor_runs_plain_and_counts_no_launch(self):
        before = torch_mv.mv_cluster_op.launches
        counts, motion = torch_mv.mv_cluster_op(
            torch.zeros((2, 8, 4), dtype=torch.int16),
            torch.tensor([8, 0], dtype=torch.int32), self.GEOM, 16, 1, 1,
            SHIFT)
        assert torch_mv.mv_cluster_op.launches == before
        assert counts.tolist() == [0, 0] and motion.tolist() == [False] * 2

    def test_empty_batch(self):
        counts, motion = torch_mv.mv_cluster_op(
            torch.zeros((0, 8, 4), dtype=torch.int16),
            torch.zeros((0,), dtype=torch.int32), self.GEOM, 16, 1, 1, SHIFT)
        assert counts.shape == motion.shape == (0,)

    @pytest.mark.parametrize("bad", ["dtype", "shape", "counts", "stride",
                                     "device"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        mvs = torch.zeros((4, 8, 4), dtype=torch.int16)
        counts = torch.zeros((4,), dtype=torch.int32)
        if bad == "dtype":
            mvs = mvs.to(torch.int32)
        elif bad == "shape":
            mvs = torch.zeros((4, 8, 5), dtype=torch.int16)
        elif bad == "counts":
            counts = counts.to(torch.int64)
        elif bad == "stride":
            mvs = torch.zeros((8, 4, 4), dtype=torch.int16).transpose(0, 1)
        else:
            mvs, counts = mvs.to("meta"), counts.to("meta")
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            torch_mv.mv_cluster_op(mvs, counts, self.GEOM, 16, 1, 1, SHIFT)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_mv_vote.py)")


@pytest.mark.cuda
@pytest.mark.parametrize("dims,m,global_hist", [
    ((640, 480), 300, False), ((640, 480), 300, True),
    ((1920, 1080), 8192, False), ((3840, 2160), 3000, False),
    ((7680, 4320), 2048, None)])
def test_cuda_kernel_matches_plain(dims, m, global_hist):
    _need_cuda()
    cfg = Config()
    geom = GridGeometry.build(*dims, cfg)
    rng = np.random.default_rng(m)
    counts = np.exp(rng.uniform(0, np.log(m), size=777)).astype(np.int32)
    counts[::50] = 0
    counts[1] = m
    mvs = random_mvs(m, counts, m, *dims)
    dev_mvs = torch.from_numpy(mvs).cuda()
    dev_counts = torch.from_numpy(counts).cuda()
    for vn in VECTORS_NEEDED:
        before = torch_mv.mv_cluster_op.launches
        got = torch_mv.mv_cluster_op(dev_mvs, dev_counts, geom, 16, vn, 2,
                                     SHIFT, global_histogram=global_hist)
        torch.cuda.synchronize()
        assert torch_mv.mv_cluster_op.launches == before + 1
        plain = torch_mv.mv_cluster_counts_plain(dev_mvs, dev_counts, geom,
                                                 16, vn, SHIFT)
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      plain.cpu().numpy())
        np.testing.assert_array_equal(
            got[1].cpu().numpy(), (plain.cpu().numpy() >= 2) & (counts > 0))
    if dims == (7680, 4320):
        assert torch_mv.uses_global_histogram(geom, dev_mvs.device)


@pytest.mark.cuda
@pytest.mark.parametrize("vn", VECTORS_NEEDED)
def test_cuda_kernel_int16_extremes(vn):
    _need_cuda()
    _, tg = geoms(GEOMETRIES[0])
    mvs, counts = extreme_frame(64, 640, 480)
    got = torch_mv.mv_cluster_op(
        torch.from_numpy(mvs).cuda(), torch.from_numpy(counts).cuda(), tg,
        16, vn, 1, SHIFT)
    assert_equal((got[0].cpu(), got[1].cpu()), port(mvs, counts, tg, 16.0,
                                                    vn))


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [1, 2])
@pytest.mark.parametrize("dims,m", [((640, 480), 300), ((1920, 1080), 8192)])
def test_cuda_kernel_hot_cells(dims, m, cells):
    """Every MV of a frame in one cell, or in two neighbouring cells: all
    of a warp's atomics on one or two addresses, and a lone cell's vote
    at every threshold."""
    _need_cuda()
    geom = GridGeometry.build(*dims, Config())
    counts = np.array([m, m // 2, 1, 0, 17], np.int32)
    mvs = hot_cell_mvs(counts, m, geom, cells)
    dev_mvs = torch.from_numpy(mvs).cuda()
    dev_counts = torch.from_numpy(counts).cuda()
    for vn in VECTORS_NEEDED + (m, m + 1):
        got = torch_mv.mv_cluster_op(dev_mvs, dev_counts, geom, 16, vn, 1,
                                     SHIFT)
        torch.cuda.synchronize()
        assert_equal((got[0].cpu(), got[1].cpu()),
                     port(mvs, counts, geom, 16.0, vn))
