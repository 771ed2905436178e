"""mvtrim_tpu_torch sweep and segmentation ops and the tune tool vs JAX.

The port's sweep ops (plain PyTorch on CPU tensors) must equal the JAX
sweep ops exactly (integer decisions); its segmentation op must equal
``make_segment_op`` vmapped over the config columns: starts, ends and
count exactly, kept seconds within rtol 1e-6 (float32 sums may be taken
in another order).  ``tune``'s rows for the grids, mv_raw and SAD routes
equal the JAX tool's, with and without ``--device-stats`` and ``--mesh``;
under ``--device-stats`` ``saved_pct`` may differ by 0.01 (it is rounded
from those f32 sums).
The ``cuda``-marked test holds the sweep ops on the card against the CPU
(``python -m pytest -m cuda tests/test_torch_sweep.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.ops import sad as jax_sad
from mvtrim_tpu.ops import sweep as jax_sweep
from mvtrim_tpu.ops.segmentation import make_segment_op
from mvtrim_tpu.tools import tune as jax_tune
from mvtrim_tpu_torch.core import Config, GridGeometry
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.ops import sweep as torch_sweep
from mvtrim_tpu_torch.ops.sad import sad_threshold_sum
from mvtrim_tpu_torch.ops.segmentation import segment_op
from mvtrim_tpu_torch.tools import tune as torch_tune

VECS = np.array([0, 1, 2, 255, 2], np.int32)
CLUS = np.array([1, 2, 1, 1, 0], np.int32)


def geoms(w, h, vm=0.05):
    return (JaxGeometry.build(w, h, JaxConfig(vertical_mask=vm)),
            GridGeometry.build(w, h, Config(vertical_mask=vm)))


@pytest.mark.parametrize("dims", [(640, 480, 0.05), (360, 240, 0.0)])
def test_vote_sweep_matches_jax(dims):
    jg, tg = geoms(*dims)
    rng = np.random.default_rng(dims[0])
    votes = rng.integers(0, 4, size=(9, tg.gh, tg.gw)).astype(np.uint8)
    votes[rng.random(votes.shape) < 0.03] = 255
    padded = np.zeros((9, jg.padded_gh, jg.padded_gw), np.uint8)
    padded[:, :tg.gh, :tg.gw] = votes
    expect = jax_sweep.make_vote_sweep_op(jg)(padded, VECS, CLUS)
    got = torch_sweep.vote_sweep_op(torch.from_numpy(votes), tg, VECS, CLUS)
    assert got.dtype == torch.bool and got.shape == (9, len(VECS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


@pytest.mark.parametrize("dims", [(320, 240), (200, 104)])
def test_sad_sweep_matches_jax(dims):
    cfg = JaxConfig()
    jg, tg = geoms(*dims)
    rng = np.random.default_rng(dims[1])
    luma = rng.integers(0, 256, size=(6, dims[1], dims[0])).astype(np.uint8)
    luma[2] = luma[1]  # one pair with no difference at all
    luma[4, :60] = luma[3, :60] + 3  # mixed: part static, part small
    bounds = np.array([sad_threshold_sum(t, 16) for t in
                       (0.0, 4.0, 12.0, 85.0, 12.0)], np.int32)
    expect = jax_sweep.make_sad_sweep_op(jg, cfg.block_size)(
        jax_sad.pad_luma(luma, jg, cfg.block_size), bounds, CLUS)
    got = torch_sweep.sad_sweep_op(torch.from_numpy(luma), tg, 16, bounds,
                                   CLUS)
    assert got.shape == (5, len(CLUS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))


def test_mv_sweep_matches_jax():
    jg, tg = geoms(640, 480)
    rng = np.random.default_rng(3)
    counts = np.array([0, 1, 50, 200, 300, 300], np.int32)
    mvs = np.zeros((6, 300, 4), np.int16)
    mvs[..., 0] = rng.integers(-32, 672, size=(6, 300))
    mvs[..., 1] = rng.integers(-32, 512, size=(6, 300))
    mvs[:, :150, 0] = rng.integers(160, 224, size=(6, 150))
    mvs[:, :150, 1] = rng.integers(120, 168, size=(6, 150))
    mvs[..., 2:] = mvs[..., :2] - rng.integers(-8, 9, size=(6, 300, 2))
    mvs[5, :4] = (32767, 32767, -32768, -32768)
    bounds = np.array([16, 16, 65, 0, -5], np.int32)
    f = mvs.astype(np.int32)
    expect = jax_sweep.make_mv_sweep_op(jg, 4)(
        f[..., 0], f[..., 1], f[..., 2], f[..., 3], counts, bounds, VECS,
        CLUS)
    got = torch_sweep.mv_sweep_op(torch.from_numpy(mvs),
                                  torch.from_numpy(counts), tg, 4, bounds,
                                  VECS, CLUS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expect))
    assert not got[0].any()  # count 0: False in every column


@pytest.mark.parametrize("seed", range(6))
def test_segment_op_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(1, 400)), int(rng.integers(1, 6))
    s = int(rng.integers(1, 12))
    ts = np.sort(rng.random(n) * 120).astype(np.float32)
    motion = rng.random((n, k)) < rng.random()
    dur = float(rng.random() * 130)
    gap, pad = float(rng.random() * 6), float(rng.random() * 2)
    op = make_segment_op(s, max_gap_sec=gap, padding_sec=pad)
    want = jax.vmap(lambda col: op(jnp.asarray(ts), col, jnp.float32(dur)),
                    in_axes=1)(jnp.asarray(motion))
    got = segment_op(torch.from_numpy(ts), torch.from_numpy(motion), dur,
                     max_segments=s, max_gap_sec=gap, padding_sec=pad)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-6)


def test_segment_op_saturates_at_capacity():
    ts = np.arange(10, dtype=np.float32) * 10.0  # every gap exceeds 5 s
    motion = np.ones((10, 1), bool)
    starts, ends, count, kept = segment_op(
        torch.from_numpy(ts), torch.from_numpy(motion), 100.0,
        max_segments=3, max_gap_sec=5.0, padding_sec=0.5)
    assert count.tolist() == [3]
    assert starts[0].tolist() == [0.0, 9.5, 19.5]
    assert ends[0].tolist() == [0.5, 10.5, 20.5]
    assert kept.tolist() == pytest.approx([2.5])


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tune") / "cam.mp4")
    native.synthesize(path, width=320, height=240, fps=25.0, duration=16.0,
                      codec="libx264", noise=2,
                      motion_windows=((2.0, 5.0), (10.0, 12.0)))
    return path


def assert_rows(ours, theirs, device_stats):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        if device_stats:
            assert abs(a.pop("saved_pct") - b.pop("saved_pct")) <= 0.01
        assert a == b


@pytest.mark.parametrize("device_stats", [False, True])
@pytest.mark.parametrize("scan_input", ["grids", "mv_raw"])
def test_tune_mv_routes_match_jax(clip, scan_input, device_stats):
    kw = dict(device_stats=device_stats, scan_input=scan_input,
              batch_frames=64)
    ours = torch_tune.sweep(clip, [4.0, 16.0, 64.0], [0, 1, 2], [1, 2],
                            cfg=Config(scan_backend="torch",
                                       chunk_duration_sec=7.0), **kw)
    theirs = jax_tune.sweep(clip, [4.0, 16.0, 64.0], [0, 1, 2], [1, 2],
                            cfg=JaxConfig(chunk_duration_sec=7.0), **kw)
    assert_rows(ours, theirs, device_stats)
    assert {r["motion_frames"] for r in ours} != {0}


def test_tune_mv_raw_overflow_matches_jax(clip):
    ours = torch_tune.sweep(clip, [4.0], [1, 2], [2], scan_input="mv_raw",
                            cfg=Config(scan_backend="torch", mv_capacity=16))
    theirs = jax_tune.sweep(clip, [4.0], [1, 2], [2], scan_input="mv_raw",
                            cfg=JaxConfig(mv_capacity=16))
    assert_rows(ours, theirs, False)
    assert ours == torch_tune.sweep(clip, [4.0], [1, 2], [2],
                                    cfg=Config(scan_backend="torch"))


@pytest.mark.parametrize("device_stats", [False, True])
def test_tune_sad_matches_jax(clip, device_stats):
    kw = dict(device_stats=device_stats, batch_frames=32)
    ours = torch_tune.sweep_sad(clip, [0.5, 4.0, 12.0], [1, 2],
                                cfg=Config(scan_backend="torch",
                                           chunk_frames_cap=40), **kw)
    theirs = jax_tune.sweep_sad(clip, [0.5, 4.0, 12.0], [1, 2],
                                cfg=JaxConfig(chunk_frames_cap=40), **kw)
    assert_rows(ours, theirs, device_stats)


def test_tune_main(clip, capsys, monkeypatch):
    monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
    assert torch_tune.main([clip, "--thresholds", "16", "--vectors", "2",
                            "--clusters", "1,2", "--device-stats"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["stats"] for r in rows] == ["device_f32"] * 2
    with pytest.raises(SystemExit):
        torch_tune.main([clip, "--scan-input", "sad", "--vectors", "1"])


def _mesh_rows(main, clip, capsys, args):
    assert main([clip] + args) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("device_stats", [False, True])
@pytest.mark.parametrize("n,s", [(2, 1), (4, 2), (8, 2)])
@pytest.mark.parametrize("route", ["grids", "sad"])
def test_tune_mesh_matches_jax(clip, capsys, monkeypatch, route, n, s,
                               device_stats):
    """``tune --mesh N --mesh-sweep S`` prints the JAX tool's rows: frames
    over the mesh's 'data' axis, configs over 'sweep' (CPU shards here,
    the suite's virtual CPU devices there)."""
    args = ["--mesh", str(n), "--mesh-sweep", str(s), "--clusters", "1,2"]
    if route == "sad":
        args += ["--scan-input", "sad", "--thresholds", "0.5,4,12"]
    else:
        args += ["--thresholds", "4,16", "--vectors", "0,1,2"]
    if device_stats:
        args.append("--device-stats")
    monkeypatch.setenv("CHUNK_DURATION_SEC", "7.0")
    monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
    ours = _mesh_rows(torch_tune.main, clip, capsys, args)
    # the mesh changes nothing: the single-device rows
    assert _mesh_rows(torch_tune.main, clip, capsys, args[4:]) == ours
    monkeypatch.delenv("MVT_SCAN_BACKEND")
    theirs = _mesh_rows(jax_tune.main, clip, capsys, args)
    assert {r["motion_frames"] for r in ours} != {0}
    assert_rows(ours, theirs, device_stats)


def test_tune_mesh_rejects_mv_raw(clip):
    from mvtrim_tpu_torch.parallel.mesh import build_mesh

    with pytest.raises(ValueError, match="grids scan input only"):
        torch_tune.sweep(clip, [16.0], [2], [2], scan_input="mv_raw",
                         cfg=Config(scan_backend="torch"),
                         mesh=build_mesh(2, device="cpu"))


def test_auto_without_cuda_raises(clip, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="MVT_SCAN_BACKEND=torch"):
        torch_tune.sweep(clip, [16.0], [2], [2], cfg=Config())


def test_staging_on_cpu_holds_nothing():
    staging = torch_tune.Staging(torch.device("cpu"))
    a = np.arange(12, dtype=np.int16).reshape(3, 4)
    (t,) = staging.upload([a])
    assert t.data_ptr() == a.ctypes.data and not staging.in_flight


@pytest.mark.cuda
def test_cuda_staging_stays_bounded():
    """Many batches through one Staging: at most ``depth`` uploads hold
    pinned buffers at a time, and each upload is a copy, so the caller
    may overwrite its array at once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_sweep.py)")
    staging = torch_tune.Staging(torch.device("cuda"), depth=2)
    rng = np.random.default_rng(1)
    batch = np.empty((256, 8192, 4), np.int16)
    uploaded = []
    for _ in range(12):
        batch[:] = rng.integers(-30000, 30000, size=batch.shape[1:])
        (t,) = staging.upload([batch])
        assert len(staging.in_flight) <= 2
        uploaded.append((t, batch[0].copy()))
    for t, want in uploaded:
        np.testing.assert_array_equal(t[-1].cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_sweeps_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_sweep.py)")
    _, tg = geoms(1920, 1080)
    rng = np.random.default_rng(0)
    votes = torch.from_numpy(
        rng.integers(0, 4, size=(300, tg.gh, tg.gw)).astype(np.uint8))
    np.testing.assert_array_equal(
        torch_sweep.vote_sweep_op(votes.cuda(), tg, VECS, CLUS).cpu(),
        torch_sweep.vote_sweep_op(votes, tg, VECS, CLUS))
    luma = torch.from_numpy(
        rng.integers(0, 256, size=(9, 1080, 1920)).astype(np.uint8))
    bounds = [0, 1024, 3072, 32000, 3072]
    np.testing.assert_array_equal(
        torch_sweep.sad_sweep_op(luma.cuda(), tg, 16, bounds, CLUS).cpu(),
        torch_sweep.sad_sweep_op(luma, tg, 16, bounds, CLUS))
    counts = torch.from_numpy(rng.integers(0, 2000, 64).astype(np.int32))
    mvs = torch.from_numpy(
        rng.integers(-32, 1100, size=(64, 2000, 4)).astype(np.int16))
    np.testing.assert_array_equal(
        torch_sweep.mv_sweep_op(mvs.cuda(), counts.cuda(), tg, 4,
                                [16, 65, 0, 16, 4], VECS, CLUS).cpu(),
        torch_sweep.mv_sweep_op(mvs, counts, tg, 4, [16, 65, 0, 16, 4],
                                VECS, CLUS))
    motion = torch.from_numpy(rng.random((500, 4)) < 0.1)
    ts = torch.arange(500, dtype=torch.float32) / 25
    got = segment_op(ts.cuda(), motion.cuda(), 20.0, max_segments=16,
                     max_gap_sec=0.5, padding_sec=0.25)
    want = segment_op(ts, motion, 20.0, max_segments=16, max_gap_sec=0.5,
                      padding_sec=0.25)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)
    assert torch.allclose(got[3].cpu(), want[3], rtol=1e-6, atol=0)
