"""mvtrim_tpu_torch word-domain cluster op vs the JAX package.

Seeded numpy masks go through the port's plain PyTorch build
(word_cluster_counts_plain / cluster_words_op on CPU tensors), the JAX
XLA build, the JAX transposed Pallas kernel in interpret mode and the
NumPy oracle.  Everything is integer math, so the tolerance is exact
equality.  The CUDA kernel itself is checked by the ``cuda``-marked test,
which runs only where a card is present (``python -m pytest -m cuda
tests/test_torch_cluster.py``).
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mvtrim_tpu.core import oracle
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.ops import cluster as jax_cluster
from mvtrim_tpu_torch.core import Config, GridGeometry
from mvtrim_tpu_torch.ops import _build
from mvtrim_tpu_torch.ops import cluster as torch_cluster

GEOMETRIES = [
    ((1920, 1080), 0.05),   # gw=120: not a multiple of 32
    ((3840, 2160), 0.05),   # 4K
    ((360, 240), 0.0),      # margin 0: zero-filled rows at the frame edge
    ((200, 144), 0.05),     # gw=13 < one word
    ((1024, 576), 0.05),    # gw=64: a multiple of 32
    ((512, 2048), 0.0),     # one word per row, used == lanes
]


def jx(geom):
    """The JAX package's GridGeometry with the fields of a port one."""
    return JaxGeometry(**dataclasses.asdict(geom))


def masks(seed, b, geom):
    """bool [b, gh, gw] activity: dense (0.3) and sparse (0.002) frames
    alternate, so motion is decided both ways."""
    rng = np.random.default_rng(seed)
    density = np.where(np.arange(b) % 2 == 0, 0.3, 0.002)[:, None, None]
    return rng.random((b, geom.gh, geom.gw)) < density


def case(dims, vm, b):
    cfg = Config(vertical_mask=vm)
    geom = GridGeometry.build(dims[0], dims[1], cfg)
    active = masks(dims[0] * 7 + b, b, geom)
    bits = np.packbits(active, axis=2, bitorder="little")
    words = torch_cluster.repack_bits_words(bits, geom)
    expect = oracle.count_clusters_batch(
        active.astype(np.uint8), vectors_needed=1,
        y_min=geom.y_min, y_max=geom.y_max)
    return cfg, geom, words, expect


@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("dims,vm", GEOMETRIES)
class TestAgainstJax:
    def test_plain_matches_oracle_and_xla(self, dims, vm, b):
        cfg, geom, words, expect = case(dims, vm, b)
        _, used, lanes = jax_cluster.word_geometry(jx(geom))
        padded = np.zeros((b, lanes), np.int32)
        padded[:, :used] = words
        xla_counts, xla_motion = jax_cluster.make_cluster_words_op_xla(
            jx(geom), cfg.clusters_needed)(jnp.asarray(padded))

        plain = torch_cluster.word_cluster_counts_plain(
            torch.from_numpy(words), geom)
        counts, motion = torch_cluster.cluster_words_op(
            torch.from_numpy(words), geom, cfg.clusters_needed)
        need = oracle.effective_clusters_needed(cfg.clusters_needed)
        assert plain.dtype == counts.dtype == torch.int32
        np.testing.assert_array_equal(plain.numpy(), expect)
        np.testing.assert_array_equal(counts.numpy(), expect)
        np.testing.assert_array_equal(np.asarray(xla_counts), expect)
        np.testing.assert_array_equal(motion.numpy(), expect >= need)
        np.testing.assert_array_equal(np.asarray(xla_motion),
                                      motion.numpy())

    def test_plain_matches_pallas_transposed(self, dims, vm, b):
        """The TPU kernel this port replaces, in interpret mode, fed the
        transposed 128-lane-padded layout it takes."""
        cfg, geom, words, expect = case(dims, vm, b)
        _, used, lanes = jax_cluster.word_geometry(jx(geom))
        wt = np.zeros((lanes, b), np.int32)
        wt[:used] = words.T
        op = jax_cluster.make_cluster_words_op_pallas_T(
            jx(geom), cfg.clusters_needed, block_b=b, interpret=True)
        pallas_counts, pallas_motion = op(jnp.asarray(wt))
        counts, motion = torch_cluster.cluster_words_op(
            torch.from_numpy(words), geom, cfg.clusters_needed)
        np.testing.assert_array_equal(np.asarray(pallas_counts),
                                      counts.numpy())
        np.testing.assert_array_equal(np.asarray(pallas_motion),
                                      motion.numpy())
        np.testing.assert_array_equal(counts.numpy(), expect)


@pytest.mark.parametrize("dims,vm", GEOMETRIES)
class TestGeometryState:
    """The system has no weights: the word geometry and the centre mask
    are the state the port carries over from the JAX package."""

    def test_word_geometry_and_repack_identical(self, dims, vm):
        cfg = Config(vertical_mask=vm)
        geom = GridGeometry.build(dims[0], dims[1], cfg)
        assert torch_cluster.word_geometry(geom) == \
            jax_cluster.word_geometry(jx(geom))
        bits = np.packbits(masks(3, 5, geom), axis=2, bitorder="little")
        ours = torch_cluster.repack_bits_words(bits, geom)
        theirs = jax_cluster.repack_bits_words(bits, jx(geom))
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert ours.tobytes() == theirs.tobytes()

    def test_kernel_center_formula_matches_word_masks(self, dims, vm):
        cfg = Config(vertical_mask=vm)
        geom = GridGeometry.build(dims[0], dims[1], cfg)
        _, used, _ = jax_cluster.word_geometry(jx(geom))
        center = jax_cluster._word_masks(jx(geom))[0]
        ours = torch_cluster.center_word_mask(geom)
        assert ours.dtype == np.int32 and ours.shape == (used,)
        assert ours.tobytes() == center[:used].tobytes()
        assert not center[used:].any()


class TestWrapper:
    GEOM = GridGeometry.build(640, 480, Config())

    def test_cpu_tensor_runs_plain_and_counts_no_launch(self):
        used = torch_cluster.word_geometry(self.GEOM)[1]
        before = torch_cluster.cluster_words_op.launches
        counts, motion = torch_cluster.cluster_words_op(
            torch.zeros((3, used), dtype=torch.int32), self.GEOM, 2)
        assert torch_cluster.cluster_words_op.launches == before
        assert counts.tolist() == [0, 0, 0]
        assert motion.dtype == torch.bool and not motion.any()

    def test_empty_batch(self):
        used = torch_cluster.word_geometry(self.GEOM)[1]
        counts, motion = torch_cluster.cluster_words_op(
            torch.zeros((0, used), dtype=torch.int32), self.GEOM, 2)
        assert counts.shape == motion.shape == (0,)

    def test_clusters_needed_floor_is_one(self):
        """CLUSTERS_NEEDED <= 0 still needs one cluster (the reference
        decides inside ``if (++clusters >= need)``)."""
        used = torch_cluster.word_geometry(self.GEOM)[1]
        _, motion = torch_cluster.cluster_words_op(
            torch.zeros((2, used), dtype=torch.int32), self.GEOM, 0)
        assert not motion.any()

    @pytest.mark.parametrize("bad", ["dtype", "shape", "stride", "device"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        used = torch_cluster.word_geometry(self.GEOM)[1]
        words = torch.zeros((4, used), dtype=torch.int32)
        if bad == "dtype":
            words = words.to(torch.int64)
        elif bad == "shape":
            words = torch.zeros((4, used + 1), dtype=torch.int32)
        elif bad == "stride":
            words = torch.zeros((used, 4), dtype=torch.int32).t()
        else:
            words = words.to("meta")
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            torch_cluster.cluster_words_op(words, self.GEOM, 2)

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        """Without a working nvcc the build raises; nothing falls back."""
        monkeypatch.setattr(_build, "_lib", None)
        monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load_library()

    def test_library_name_follows_the_source(self, monkeypatch, tmp_path):
        """The library's name hashes every source: an edited, added or
        removed ``.cu`` gives a new name, an unchanged set the same."""
        src = tmp_path / "k.cu"
        src.write_text("// one\n")
        monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
        first = _build.library_path()
        assert _build.library_path() == first
        src.write_text("// two\n")
        second = _build.library_path()
        assert second != first
        (tmp_path / "l.cu").write_text("// three\n")
        assert _build.library_path() not in (first, second)
        (tmp_path / "l.cu").unlink()
        assert _build.library_path() == second
        assert first.startswith(_build.BUILD_DIR)

    def test_library_name_follows_the_headers(self, monkeypatch, tmp_path):
        """A header the sources include is hashed too: editing it names a
        new library, so no stale build is loaded."""
        (tmp_path / "k.cu").write_text('#include "rule.cuh"\n')
        (tmp_path / "rule.cuh").write_text("// one\n")
        monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
        first = _build.library_path()
        (tmp_path / "rule.cuh").write_text("// two\n")
        assert _build.library_path() != first
        assert [os.path.basename(h) for h in _build.headers()] == \
            ["rule.cuh"]
        assert [os.path.basename(s) for s in _build.sources()] == ["k.cu"]

    def test_every_source_is_built_and_bound(self):
        """Each csrc/*.cu is in the build, and each C entry point the
        wrappers call has its argument types declared."""
        names = {os.path.basename(s) for s in _build.sources()}
        assert {"word_cluster.cu", "cluster_map.cu", "sad_block.cu",
                "mv_cluster.cu"} <= names
        assert set(_build.SIGNATURES) == {
            "mvt_word_cluster_counts", "mvt_word_cluster_batch",
            "mvt_cluster_map_counts",
            "mvt_sad_block_grid", "mvt_mv_cluster_counts",
            "mvt_mv_cluster_scratch", "mvt_word_stream_control",
            "mvt_sad_stream_control", "mvt_mv_stream_control",
            "mvt_sad_compute_control", "mvt_mv_compute_control",
            "mvt_mv_capacity_control", "mvt_mv_votes_control",
            "mvt_mv_votes_scratch", "mvt_mv_matrix_control"}
        for src in _build.sources():
            with open(src) as f:
                text = f.read()
            assert any(f'extern "C" int {name}(' in text
                       for name in _build.SIGNATURES), src


@pytest.mark.cuda
@pytest.mark.parametrize("dims,vm", GEOMETRIES)
def test_cuda_kernel_matches_plain(dims, vm):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_cluster.py)")
    for b in (1, 7, 777):
        cfg, geom, words, expect = case(dims, vm, b)
        before = torch_cluster.cluster_words_op.launches
        counts, motion = torch_cluster.cluster_words_op(
            torch.from_numpy(words).cuda(), geom, cfg.clusters_needed)
        torch.cuda.synchronize()
        assert torch_cluster.cluster_words_op.launches == before + 1
        plain = torch_cluster.word_cluster_counts_plain(
            torch.from_numpy(words), geom)
        np.testing.assert_array_equal(counts.cpu().numpy(), plain.numpy())
        np.testing.assert_array_equal(counts.cpu().numpy(), expect)
        np.testing.assert_array_equal(
            motion.cpu().numpy(),
            expect >= oracle.effective_clusters_needed(cfg.clusters_needed))
