"""Twin of tests/test_fuzz.py on the port's CPU build.

The config-space fuzz of the JAX suite, every case at the same draws:
random geometries, configs and MV sets through the port's ops (the plain
versions of its kernels: ``cluster_map_op``, ``mv_cluster_op``,
``vote_sweep_op``, ``sad_op``) against the JAX package's XLA ops and the
NumPy oracle, bit for bit; the port's host segmentation against the JAX
package's; and the tune tool's grids, mv_raw and device-stats routes and
its SAD route against the JAX tool's rows on random clips and knobs.
MVT_FUZZ_N scales the trial counts as in the JAX suite.
"""

import os

import numpy as np
import pytest
import torch

from mvtrim_tpu.core import oracle as jax_oracle
from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.ops import mv_vote as jax_mv_vote
from mvtrim_tpu.ops import sad as jax_sad
from mvtrim_tpu.ops.cluster import make_cluster_op_xla, pad_votes
from mvtrim_tpu.ops.sweep import make_vote_sweep_op
from mvtrim_tpu.tools import tune as jax_tune
from mvtrim_tpu_torch.core import Config, GridGeometry, oracle
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.models.sad_detector import sad_oracle_counts
from mvtrim_tpu_torch.ops import cluster as cluster_ops
from mvtrim_tpu_torch.ops import mv_vote, sad
from mvtrim_tpu_torch.ops.sweep import vote_sweep_op
from mvtrim_tpu_torch.tools import tune

FUZZ_N = int(os.environ.get("MVT_FUZZ_N", "6"))


def random_geometry(rng):
    gw = int(rng.integers(4, 64))
    gh = int(rng.integers(4, 48))
    margin = int(rng.integers(0, max(1, gh // 3)))
    kw = dict(width=gw * 16, height=gh * 16, gw=gw, gh=gh, y_min=margin,
              y_max=gh - margin)
    return GridGeometry(**kw), JaxGeometry(**kw)


def random_mvs(rng, n, geom):
    dst = np.stack([
        rng.integers(-40, geom.width + 40, n),
        rng.integers(-40, geom.height + 40, n),
    ], axis=1)
    disp = rng.integers(-12, 13, size=(n, 2))
    return np.concatenate([dst, dst - disp], axis=1).astype(np.int64)


class TestFuzz:
    def test_cluster_kernel_random_configs(self, rng):
        for trial in range(10):
            geom, jgeom = random_geometry(rng)
            vec = int(rng.integers(0, 7))
            clust = int(rng.integers(0, 5))
            grids = rng.integers(
                0, 8, size=(6, geom.gh, geom.gw)).astype(np.uint8)
            counts, motion = cluster_ops.cluster_map_op(
                torch.from_numpy(grids), geom, vec, clust)
            j_counts, j_motion = make_cluster_op_xla(jgeom, vec, clust)(
                pad_votes(grids, jgeom))
            np.testing.assert_array_equal(counts.numpy(), np.asarray(
                j_counts)[:len(grids)])
            np.testing.assert_array_equal(motion.numpy(), np.asarray(
                j_motion)[:len(grids)])
            for i, g in enumerate(grids):
                expect = oracle.count_clusters(
                    g, vectors_needed=vec, y_min=geom.y_min,
                    y_max=geom.y_max)
                assert int(counts[i]) == expect, (trial, i, geom, vec)
                assert bool(motion[i]) == (
                    expect >= oracle.effective_clusters_needed(clust))

    def test_fused_mv_kernel_random_configs(self, rng):
        for trial in range(8):
            geom, jgeom = random_geometry(rng)
            vec = int(rng.integers(0, 5))
            clust = int(rng.integers(1, 4))
            threshold = float(rng.choice([0.0, 1.0, 4.5, 16.0, 16.5, 100.0]))
            m = 128
            mv_list = [random_mvs(rng, int(rng.integers(0, m)), geom)
                       for _ in range(4)]
            fields = np.zeros((len(mv_list), m, 4), np.int16)
            for i, mvs in enumerate(mv_list):
                fields[i, :len(mvs)] = mvs
            counts = np.array([len(v) for v in mv_list], np.int32)
            _, motion = mv_vote.mv_cluster_op(
                torch.from_numpy(fields), torch.from_numpy(counts), geom,
                mv_vote.threshold_bound(threshold), vec, clust, 4)
            dx_, dy_, sx_, sy_, j_counts, overflow = jax_mv_vote.pad_mvs(
                mv_list, m)
            assert not overflow.any()
            _, j_motion = jax_mv_vote.make_mv_cluster_op_xla(
                jgeom, threshold_sq=threshold, block_shift=4,
                vectors_needed=vec, clusters_needed=clust)(
                    dx_, dy_, sx_, sy_, j_counts)
            np.testing.assert_array_equal(motion.numpy(), np.asarray(
                j_motion)[:len(mv_list)])
            for i, mvs in enumerate(mv_list):
                expect = oracle.check_frame(
                    mvs, geom.gw, geom.gh, threshold_sq=threshold,
                    block_shift=4, y_min=geom.y_min, y_max=geom.y_max,
                    vectors_needed=vec, clusters_needed=clust)
                assert bool(motion[i]) == expect, \
                    (trial, i, geom, vec, clust, threshold)

    def test_vote_sweep_random_configs(self, rng):
        geom, jgeom = random_geometry(rng)
        grids = rng.integers(
            0, 8, size=(8, geom.gh, geom.gw)).astype(np.uint8)
        k = 6
        vecs = rng.integers(0, 7, k).astype(np.int32)
        clusts = rng.integers(0, 5, k).astype(np.int32)
        motion = vote_sweep_op(torch.from_numpy(grids), geom, vecs,
                               clusts).numpy()
        j_motion = np.asarray(make_vote_sweep_op(jgeom)(
            np.asarray(pad_votes(grids, jgeom)), vecs, clusts))
        np.testing.assert_array_equal(motion, j_motion[:len(grids)])
        for ki in range(k):
            for i, g in enumerate(grids):
                expect = oracle.count_clusters(
                    g, vectors_needed=int(vecs[ki]), y_min=geom.y_min,
                    y_max=geom.y_max)
                assert bool(motion[i, ki]) == (
                    expect >= oracle.effective_clusters_needed(
                        int(clusts[ki])))

    @pytest.mark.parametrize("seed", range(max(4, FUZZ_N)))
    def test_sad_threshold_sweep_vs_oracle(self, seed):
        """The port's SAD op (block SAD, then the cluster rule) at random
        thresholds, cluster counts and block sizes: the NumPy oracle's
        counts, and the JAX package's XLA op's."""
        rng = np.random.default_rng(3000 + seed)
        block = int(rng.choice([8, 16]))
        gw = int(rng.integers(6, 24))
        gh = int(rng.integers(6, 20))
        margin = int(rng.integers(0, 3))
        kw = dict(width=gw * block, height=gh * block, gw=gw, gh=gh,
                  y_min=margin, y_max=gh - margin)
        geom, jgeom = GridGeometry(**kw), JaxGeometry(**kw)
        thr = float(rng.choice([0.5, 2.0, 7.3, 12.0, 30.0, 200.0]))
        clust = int(rng.integers(0, 4))
        n = int(rng.integers(2, 9))
        h = jgeom.padded_gh * block
        w = jgeom.padded_gw * block
        luma = rng.integers(0, 256, size=(n, h, w), dtype=np.uint8)
        for i in range(1, n):
            if rng.random() < 0.5:
                luma[i] = np.clip(
                    luma[i - 1].astype(np.int16)
                    + rng.integers(-int(thr) - 2, int(thr) + 3,
                                   size=(h, w)), 0, 255).astype(np.uint8)
        frames = np.ascontiguousarray(luma[:, :geom.height, :geom.width])
        counts, motion = sad.sad_op(torch.from_numpy(frames), geom,
                                    sad_threshold=thr, block_size=block,
                                    clusters_needed=clust)
        expect = sad_oracle_counts(frames, geom, sad_threshold=thr,
                                   block_size=block)
        np.testing.assert_array_equal(counts.numpy(), expect,
                                      err_msg=str((seed, geom, thr)))
        np.testing.assert_array_equal(
            motion.numpy(), expect >= oracle.effective_clusters_needed(clust))
        j_counts, j_motion = jax_sad.make_sad_op_xla(
            jgeom, sad_threshold=thr, block_size=block,
            clusters_needed=clust)(luma)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
        np.testing.assert_array_equal(motion.numpy(), np.asarray(j_motion))

    def test_segmentation_random(self, rng):
        for _ in range(30):
            n = int(rng.integers(0, 40))
            ts = np.unique(np.round(np.sort(rng.uniform(0, 200, n)), 3))
            max_gap = float(rng.uniform(0.5, 20))
            pad = float(rng.uniform(0, 3))
            duration = float(rng.uniform(100, 250))
            kw = dict(max_gap_sec=max_gap, padding_sec=pad,
                      duration=duration)
            segs = oracle.segments_from_timestamps(ts, **kw)
            j_segs = jax_oracle.segments_from_timestamps(ts, **kw)
            assert [(s.start, s.end) for s in segs] == \
                [(s.start, s.end) for s in j_segs]
            assert all(0.0 <= s.start <= s.end <= duration for s in segs)
            for a, b in zip(segs, segs[1:]):
                assert a.end - pad <= b.start + pad + 1e-9
            removed, pct = oracle.savings(segs, duration)
            assert (removed, pct) == jax_oracle.savings(j_segs, duration)
            assert -1e-9 <= pct <= 100.0 + 1e-9 or n == 0


def random_clip(rng2, path, **extra):
    wins, t0 = [], 0.5
    for _ in range(int(rng2.integers(1, 3))):
        a = t0 + float(rng2.uniform(0, 1.5))
        b = a + float(rng2.uniform(0.3, 1.5))
        wins.append((a, min(b, 5.6)))
        t0 = b + 0.4
    native.synthesize(path, width=256, height=192, fps=25.0, duration=6.0,
                      codec="libx264", motion_windows=tuple(wins), **extra)


class TestTuneRouteFuzz:
    """The port's tune routes at the JAX suite's random draws: its grids
    route, mv_raw route and lazy device-stats route against the JAX
    tool's grids rows; its SAD route against the JAX tool's SAD rows."""

    @pytest.mark.parametrize("seed", range(max(3, FUZZ_N // 2)))
    def test_grids_and_mv_raw_agree(self, seed, tmp_path):
        rng2 = np.random.default_rng(7000 + seed)
        clip = str(tmp_path / f"t{seed}.mp4")
        random_clip(rng2, clip)
        thresholds = sorted(
            float(x) for x in rng2.choice(
                [0.0, 1.0, 4.0, 16.5, 64.0], size=2, replace=False))
        vectors = [int(v) for v in rng2.choice(
            [0, 1, 2, 3, 255, 256, -1], size=2, replace=False)]
        clusters = [int(c) for c in rng2.choice(
            [0, 1, 2, 4], size=2, replace=False)]
        knobs = dict(chunk_duration_sec=float(rng2.choice([1.7, 5.0])),
                     target_fps=int(rng2.choice([0, 7])))
        batch = int(rng2.choice([16, 64]))
        want = jax_tune.sweep(clip, thresholds, vectors, clusters,
                              cfg=JaxConfig(**knobs), batch_frames=batch)
        kw = dict(cfg=Config(scan_backend="torch", **knobs),
                  batch_frames=batch)
        a = tune.sweep(clip, thresholds, vectors, clusters, **kw)
        b = tune.sweep(clip, thresholds, vectors, clusters,
                       scan_input="mv_raw", **kw)
        assert a == want, (seed, thresholds, vectors, clusters)
        assert b == want, (seed, thresholds, vectors, clusters)
        d = tune.sweep(clip, thresholds, vectors, clusters,
                       device_stats=True, **kw)
        for ra, rd in zip(want, d):
            assert rd["motion_frames"] == ra["motion_frames"], (ra, rd)
            assert rd["segments"] == ra["segments"], (ra, rd)

    @pytest.mark.parametrize("seed", range(max(3, FUZZ_N // 2)))
    def test_sad_sweep_matches_detector_runs(self, seed, tmp_path):
        rng2 = np.random.default_rng(9000 + seed)
        clip = str(tmp_path / f"s{seed}.mp4")
        random_clip(rng2, clip, noise=int(rng2.integers(0, 4)))
        thresholds = sorted(
            float(x) for x in rng2.choice(
                [0.0, 0.5, 2.0, 12.0, 60.0, 200.0], size=2,
                replace=False))
        clusters = [int(c) for c in rng2.choice(
            [0, 1, 2, 4], size=2, replace=False)]
        knobs = dict(chunk_duration_sec=float(rng2.choice([1.7, 5.0])),
                     target_fps=int(rng2.choice([0, 7])),
                     chunk_frames_cap=int(rng2.choice([0, 13])))
        batch = int(rng2.choice([16, 64]))
        want = jax_tune.sweep_sad(clip, thresholds, clusters,
                                  cfg=JaxConfig(**knobs), batch_frames=batch)
        kw = dict(cfg=Config(scan_backend="torch", **knobs),
                  batch_frames=batch)
        got = tune.sweep_sad(clip, thresholds, clusters, **kw)
        assert got == want, (seed, thresholds, clusters)
        d = tune.sweep_sad(clip, thresholds, clusters, device_stats=True,
                           **kw)
        for rg, rd in zip(got, d):
            assert rd["motion_frames"] == rg["motion_frames"], (rg, rd)
            assert rd["segments"] == rg["segments"], (rg, rd)
