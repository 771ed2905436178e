"""The port's bench (``mvtrim_tpu_torch/bench/``) against the JAX package's.

* The plain versions of the controls against the TPU controls themselves,
  run in Pallas's TPU interpret mode on the same seeded numpy inputs:
  ``bench.build_control_sweep_T`` (one buffer, one pass) for C1,
  ``sad_bench``'s ``ctrlf<B>`` for C2 and ``compf1`` (with its host
  expectation ``comp_expected``) for C4, ``mv_bench``'s ``ctrl`` at full
  counts for C3; C3 at sparse counts and C5 against NumPy statements of
  their functions.  ``bench.py`` and ``benchmarks/*`` are loaded by path,
  nothing in them edited.  Every comparison is exact (integer functions).
* The audit: a wrong checksum or a rate above 105% of the roofline is
  INVALID, and the rotation total is ``bench._expected_total``'s.
* ``python -m mvtrim_tpu_torch.bench --device cpu --quick``, the feeder
  and dispatch-batch legs on the CPU, as ``tests/test_bench_smoke.py``
  runs the JAX ones.
* ``cuda``-marked: each control against its plain version on the card
  (bases 1 B and 4 B off, the bits' 15 B pitch), and a product op captured
  in a CUDA graph against eager calls (``python -m pytest -m cuda
  tests/test_torch_bench.py`` on a card).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu_torch.bench import audit, controls
from mvtrim_tpu_torch.core import oracle
from mvtrim_tpu_torch.core.config import Config
from mvtrim_tpu_torch.core.types import GridGeometry
from mvtrim_tpu_torch.ops import cluster as cluster_ops
from mvtrim_tpu_torch.ops import mv_vote as mv_ops
from mvtrim_tpu_torch.ops import sad as sad_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str, rel: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_bench():
    return load("bench_reference", "bench.py")


@pytest.fixture(scope="module")
def sad_bench():
    return load("sad_bench_reference", "benchmarks/sad_bench.py")


@pytest.fixture(scope="module")
def mv_bench():
    return load("mv_bench_reference", "benchmarks/mv_bench.py")


def random_bits(rng, b: int, geom) -> np.ndarray:
    return rng.integers(0, 256, size=(b, geom.gh, (geom.gw + 7) // 8),
                        dtype=np.uint8)


def seeded_mvs(rng, b: int, m: int, width: int, height: int):
    """int32 (dst_x, dst_y, src_x, src_y) [b, m] as mv_bench.py draws
    them."""
    dst_x = rng.integers(-32, width + 32, size=(b, m)).astype(np.int32)
    dst_y = rng.integers(-32, height + 32, size=(b, m)).astype(np.int32)
    src_x = (dst_x - rng.integers(-8, 9, size=(b, m))).astype(np.int32)
    src_y = (dst_y - rng.integers(-8, 9, size=(b, m))).astype(np.int32)
    return dst_x, dst_y, src_x, src_y


def as_payload(fields) -> torch.Tensor:
    return torch.from_numpy(np.stack(fields, axis=2).astype(np.int16))


# --- C1 against bench.build_control_sweep_T ---

@pytest.mark.parametrize("dims", [(1920, 1080), (320, 240), (200, 144),
                                  (1024, 576)])
@pytest.mark.parametrize("payload", ["bits", "words"])
def test_word_stream_control_matches_the_jax_control(jax_bench, dims,
                                                     payload):
    import jax

    rng = np.random.default_rng(sum(dims))
    cfg = Config()
    geom = GridGeometry.build(*dims, cfg)
    b = 8
    bits = random_bits(rng, b, geom)
    words = cluster_ops.repack_bits_words(bits, geom)       # [b, used]
    gww, used, lanes = cluster_ops.word_geometry(geom)
    stacked_t = np.zeros((1, lanes, b), np.int32)
    stacked_t[0, :used] = words.T
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(jax_bench.build_control_sweep_T(
            1, lanes, b, b, 1))(stacked_t))[0]
    t = torch.from_numpy(bits) if payload == "bits" \
        else torch.from_numpy(np.ascontiguousarray(words))
    rows = controls.word_rows(t, geom)
    assert rows.shape[2] == ((geom.gw + 7) // 8 if payload == "bits"
                             else 4 * gww)
    np.testing.assert_array_equal(
        controls.word_stream_control_plain(rows, geom).numpy(), want)
    np.testing.assert_array_equal(
        controls.word_stream_control(t, geom).numpy(), want)


def test_word_stream_control_reads_bit0_of_each_word():
    """1080p bits rows are 15 B: words 0..3 start at bytes 0, 4, 8, 12."""
    geom = GridGeometry.build(1920, 1080, Config())
    rows = torch.zeros((2, geom.gh, 15), dtype=torch.uint8)
    rows[0, :, [0, 4, 8, 12]] = 1
    rows[1, :, [1, 2, 3, 13, 14]] = 0xFF     # no word's bit 0
    rows[1, 5, 12] = 0xFF
    got = controls.word_stream_control(rows, geom).tolist()
    assert got == [4 * geom.gh, 1]


# --- C2 and C4 against sad_bench's ctrlf<B> and compf1 ---

def padded(luma: np.ndarray, width: int, height: int) -> np.ndarray:
    geom = JaxGeometry.build(width, height, JaxConfig())
    bs = JaxConfig().block_size
    return sad_ops.pad_luma(luma, geom, bs), geom


@pytest.mark.parametrize("dims", [(160, 96), (200, 120), (64, 64)])
def test_sad_stream_control_matches_the_jax_ctrl(sad_bench, dims):
    width, height = dims
    rng = np.random.default_rng(width)
    b = 4
    luma = rng.integers(0, 256, size=(1 + b, height, width), dtype=np.uint8)
    lp, jgeom = padded(luma, width, height)
    with pltpu.force_tpu_interpret_mode():
        run = sad_bench.build_variant(f"ctrlf{b}", jgeom, JaxConfig(), k=1,
                                      b=1 + b, iters=1)
        want = np.asarray(run((lp[:1], lp[1:])))
    geom = GridGeometry.build(width, height, Config())
    grid = controls.sad_stream_control(torch.from_numpy(luma), geom, 16)
    assert tuple(grid.shape) == (b, geom.gh, geom.gw)
    np.testing.assert_array_equal(grid.sum(dim=(1, 2)).numpy(), want)


@pytest.mark.parametrize("dims", [(160, 96), (200, 120)])
def test_sad_compute_control_matches_the_jax_comp(sad_bench, dims):
    width, height = dims
    rng = np.random.default_rng(height)
    b = 4
    luma = rng.integers(0, 256, size=(1 + b, height, width), dtype=np.uint8)
    luma[1, 16:48, 16:48] = 255
    lp, jgeom = padded(luma, width, height)
    jcfg = JaxConfig()
    with pltpu.force_tpu_interpret_mode():
        run = sad_bench.build_variant("compf1", jgeom, jcfg, k=1, b=1 + b,
                                      iters=1)
        want = np.asarray(run((lp[:1], lp[1:])))
    expect, _ = sad_bench.comp_expected("compf1", lp, jgeom, jcfg, 1 + b)
    np.testing.assert_array_equal(want, expect)
    cfg = Config()
    geom = GridGeometry.build(width, height, cfg)
    grid = controls.sad_compute_control(torch.from_numpy(luma), geom, 16)
    bound = sad_ops.sad_threshold_sum(cfg.sad_threshold, cfg.block_size)
    counts = cluster_ops.cluster_map_counts_plain(grid, geom, bound)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert int(grid[1:].abs().sum()) == 0
    np.testing.assert_array_equal(
        grid[0].numpy(),
        sad_ops.sad_block_grid_plain(torch.from_numpy(luma[:2]), 16)[0])


# --- C3 against mv_bench's ctrl; C3 and C5 against NumPy statements ---

@pytest.mark.parametrize("m", [256, 1000])
def test_mv_stream_control_matches_the_jax_ctrl_at_full_counts(mv_bench, m):
    rng = np.random.default_rng(m)
    b = 4
    fields = seeded_mvs(rng, b, m, 1920, 1080)
    counts = np.full((b,), m, np.int32)
    with pltpu.force_tpu_interpret_mode():
        run = mv_bench.build_variant(
            "ctrl", JaxGeometry.build(1920, 1080, JaxConfig()), JaxConfig(),
            k=1, b=b, m=m, iters=1, fps=1)
        want = np.asarray(run(*(f.reshape(b, 1, m) for f in fields), None,
                              counts))
    got = controls.mv_stream_control(as_payload(fields),
                                     torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mv_stream_control_reads_only_rows_below_the_count():
    rng = np.random.default_rng(5)
    b, m = 6, 300
    fields = seeded_mvs(rng, b, m, 1920, 1080)
    counts = np.array([0, 1, 17, 299, 300, 450], np.int32)
    got = controls.mv_stream_control(as_payload(fields),
                                     torch.from_numpy(counts)).numpy()
    want = [int(counts[i]) + sum(int(f[i, :min(counts[i], m)].sum())
                                 for f in fields) for i in range(b)]
    np.testing.assert_array_equal(got, want)


def test_mv_stream_control_wraps_to_int32():
    mvs = torch.full((1, 40000, 4), 32767, dtype=torch.int16)
    counts = torch.tensor([40000], dtype=torch.int32)
    total = 4 * 40000 * 32767 + 40000
    want = (total + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert controls.mv_stream_control(mvs, counts).tolist() == [want]


@pytest.mark.parametrize("count0", [0, 1, 300])
def test_mv_compute_control_is_frame_zeros_decision(count0):
    rng = np.random.default_rng(count0)
    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    b, m = 5, 512
    fields = list(seeded_mvs(rng, b, m, 1920, 1080))
    # a cluster in frame 0: 8 x 8 cells of two votes each
    k = np.arange(128)
    fields[0][0, :128] = 400 + (k % 8) * 16
    fields[1][0, :128] = 400 + (k // 8 % 8) * 16
    fields[2][0, :128] = fields[0][0, :128] - 8
    fields[3][0, :128] = fields[1][0, :128] - 8
    counts = np.array([count0, 512, 100, 7, 0], np.int32)
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    got, motion = controls.mv_compute_control(
        as_payload(fields), torch.from_numpy(counts), geom, bound,
        cfg.vectors_needed, cfg.clusters_needed, cfg.block_shift)
    mvs0 = np.stack([f[0, :count0] for f in fields], axis=1)
    grid = oracle.vote_grid(mvs0.astype(np.int64), geom.gw, geom.gh,
                            threshold_sq=cfg.mv_threshold_sq,
                            block_shift=cfg.block_shift, y_min=geom.y_min,
                            y_max=geom.y_max)
    want = oracle.count_clusters(grid, vectors_needed=cfg.vectors_needed,
                                 y_min=geom.y_min, y_max=geom.y_max)
    assert got.tolist() == [want] * b
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    assert motion.tolist() == [want >= need and count0 > 0] * b
    if count0 == 300:
        assert want >= need


# --- the wrappers' checks ---

def test_controls_raise_on_other_devices_and_bad_inputs():
    geom = GridGeometry.build(320, 240, Config())
    meta = torch.empty((2, geom.gh, (geom.gw + 7) // 8), dtype=torch.uint8,
                       device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        controls.word_stream_control(meta, geom)
    with pytest.raises(ValueError):
        controls.word_stream_control(
            torch.zeros((2, geom.gh, 7), dtype=torch.uint8), geom)
    with pytest.raises(TypeError):
        controls.sad_stream_control(
            torch.zeros((3, 240, 320), dtype=torch.int16), geom, 16)
    with pytest.raises(ValueError, match="carry"):
        controls.sad_compute_control(
            torch.zeros((1, 240, 320), dtype=torch.uint8), geom, 16)
    with pytest.raises(ValueError):
        controls.mv_stream_control(torch.zeros((2, 8, 3), dtype=torch.int16),
                                   torch.zeros((2,), dtype=torch.int32))


# --- the audit ---

@pytest.mark.parametrize("per_buffer,k,n", [
    ([3, 5], 2, 7), ([1, 2, 3, 4], 4, 4), ([10 ** 12, 7, 9], 3, 100),
    ([0, 1, 2, 3, 4], 5, 2)])
def test_expected_total_is_the_jax_bench_rotation(jax_bench, per_buffer, k,
                                                  n):
    assert audit.expected_total(per_buffer, k, n) == \
        jax_bench._expected_total(per_buffer, k, n)


def test_gate():
    ok = audit.gate(1e-3, 1e9, True)               # 1 TB/s
    assert ok["valid"] and ok["implied_gbps"] == pytest.approx(1000.0)
    assert not audit.gate(1e-3, 1e9, False)["valid"]
    fast = audit.gate(1e-3, 1.06 * audit.HBM_BYTES_PER_S * 1e-3, True)
    assert not fast["valid"] and fast["pct_of_roofline"] > 105
    assert audit.gate(1e-3, 1.04 * audit.HBM_BYTES_PER_S * 1e-3,
                      True)["valid"]


def card_run() -> audit.Run:
    return audit.Run(device=torch.device("cpu"), card=audit.CPU_LABEL)


def test_measure_flags_a_wrong_checksum_invalid():
    inputs = [torch.arange(4, dtype=torch.int32),
              torch.ones(4, dtype=torch.int32)]
    per_input = [int(t.sum()) for t in inputs]
    good = audit.measure(card_run(), lambda t: t.clone(), inputs, per_input,
                         n=5, nbytes=16, frames=4, kernel=None)
    assert good["valid"] and good["us"] is not None
    bad = audit.measure(card_run(), lambda t: t + 1, inputs, per_input,
                        n=5, nbytes=16, frames=4, kernel=None)
    assert not bad["valid"] and bad["us"] is None
    assert bad["frames_per_s"] is None


def test_measure_flags_a_rate_over_the_roofline_invalid(monkeypatch):
    # a run on a card (any device but the CPU), its graph timing stubbed
    run = audit.Run(device=torch.device("meta"), card="a card")
    monkeypatch.setattr(audit, "graph_time", lambda *a: {
        "runs_us": [1.0], "checksum_ok": True})
    monkeypatch.setattr(audit, "host_time", lambda *a: 1.0)
    m = audit.measure(run, None, [None], [0], n=1, nbytes=4e6, frames=1,
                      kernel=None)                  # 4 TB/s
    assert not m["valid"] and m["us"] is None
    m = audit.measure(run, None, [None], [0], n=1, nbytes=3e6, frames=1,
                      kernel=None)                  # 3 TB/s
    assert m["valid"] and m["us"] == 1.0
    assert m["implied_gbps"] == pytest.approx(3000.0)


def test_rotation_holds_twice_the_l2():
    assert audit.rotation(card_run(), 1e6) == 2     # the CPU: two buffers
    card = audit.Run(device=torch.device("meta"), card="a card")
    assert audit.rotation(card, 2_090_000) == 48    # K1 bits, B = 2048
    assert audit.rotation(card, 135e6) == 2         # a 1080p SAD window
    card.quick = True
    assert audit.rotation(card, 2_090_000) == 2
    assert audit.launches(card, 2, 256) == audit.QUICK_LAUNCHES
    card.quick = False
    assert audit.launches(card, 48, 256) == 256
    assert audit.launches(card, 300, 256) == 300


# --- the entry points on the CPU ---

def run_module(*args, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def json_lines(stdout: str) -> list[str]:
    return [ln for ln in stdout.splitlines() if ln.startswith("{")]


def test_bench_cpu_quick_prints_one_headline_last():
    r = run_module("mvtrim_tpu_torch.bench", "--device", "cpu", "--quick")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = json_lines(r.stdout)
    assert len(lines) == 1 and r.stdout.splitlines()[-1] == lines[0]
    rec = json.loads(lines[0])
    assert rec["metric"] == "1080p_scan_frames_per_sec_per_chip"
    for key in ("value", "unit", "impl", "roofline_gbps", "bytes_per_frame",
                "audit", "control_gbps", "pct_of_control"):
        assert key in rec, key
    assert rec["value"] > 0 and rec["all_audited"]
    assert rec["timing"] == "cpu-plain" and rec["impl"].startswith(
        "cpu-plain")
    assert rec["control_gbps"] is None        # no card rate from the CPU
    for family in ("words", "grids", "mv", "sad"):
        cells = rec[f"secondary_{family}"]
        assert cells and all(c["valid"] and c["timing"] == "cpu-plain"
                             for c in cells.values())
    assert set(rec["secondary_sad"]["1080p B=64"]) >= {
        "op_us", "stream_control_us", "compute_control_us"}
    text = r.stdout.splitlines()
    assert sum(line.startswith(("words ", "grids ", "mv ", "sad "))
               for line in text) == 14


def test_bench_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run on it")
    r = run_module("mvtrim_tpu_torch.bench", "--quick")
    assert r.returncode == 2
    assert not json_lines(r.stdout)
    assert "--device cpu" in r.stderr


@pytest.mark.parametrize("dispatch", ["null", "device"])
def test_feeder_cpu_legs(dispatch):
    r = run_module("mvtrim_tpu_torch.bench.feeder", "--device", "cpu",
                   "--dispatch", dispatch, "--producers", "1,3",
                   "--frames", "600", "--chunk", "128", "--width", "320",
                   "--height", "240")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = json_lines(r.stdout)
    assert len(lines) == 1 and r.stdout.splitlines()[-1] == lines[0]
    rec = json.loads(lines[0])
    assert rec["bench"] == "feeder" and rec["dispatch"] == dispatch
    assert rec["card"] == "cpu-plain" and rec["decode"] == "excluded"
    assert [(row["payload"], row["producers"]) for row in rec["rows"]] == [
        ("bits", 1), ("bits", 3), ("words", 1), ("words", 3)]
    for row in rec["rows"]:
        assert row["frames"] == 640 and row["frames_per_sec"] > 0
        if dispatch == "null":
            assert row["motion_frames"] == 0
    if dispatch == "device":
        # the same chunks decide the same way over either payload
        motion = {}
        for row in rec["rows"]:
            motion.setdefault(row["producers"], set()).add(
                row["motion_frames"])
        assert all(len(m) == 1 and m.pop() > 0 for m in motion.values())


def test_dispatch_batch_cpu_leg():
    r = run_module("mvtrim_tpu_torch.bench.dispatch_batch", "--device",
                   "cpu", "--videos", "3", "--frames", "16", "--width",
                   "320", "--height", "240", "--repeats", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = json_lines(r.stdout)
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["bench"] == "dispatch_batch" and rec["platform"] == "cpu"
    assert "bit-equal the oracle" in rec["audit"]
    for strat in ("pervideo", "pipelined", "merged"):
        assert rec[strat]["median_s"] > 0
    assert rec["pervideo"]["dispatches"] == 3
    assert rec["merged"]["dispatches"] == 1


def test_feeder_and_dispatch_batch_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for module in ("mvtrim_tpu_torch.bench.feeder",
                   "mvtrim_tpu_torch.bench.dispatch_batch"):
        r = run_module(module)
        assert r.returncode == 2 and "--device cpu" in r.stderr


# --- on the card ---

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_bench.py)")


def offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    buf = torch.empty(t.numel() * t.element_size() + nbytes,
                      dtype=torch.uint8, device=t.device)
    return buf[nbytes:].view(t.dtype).view(t.shape).copy_(t)


def check_exact(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().to(torch.int64), want.cpu().to(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,b", [((1920, 1080), 2048), ((1920, 1080), 750),
                                    ((3840, 2160), 777), ((200, 144), 5)])
@pytest.mark.parametrize("payload,off", [("bits", 0), ("bits", 1),
                                         ("words", 0), ("words", 4)])
def test_cuda_word_stream_control(dims, b, payload, off):
    need_card()
    geom = GridGeometry.build(*dims, Config())
    bits = torch.from_numpy(random_bits(np.random.default_rng(b), b, geom))
    t = bits if payload == "bits" else cluster_ops.bits_to_words(bits, geom)
    t = offset(t.cuda(), off)
    if payload == "bits" and dims == (1920, 1080):
        assert t.shape[2] == 15
    before = controls.word_stream_control.launches
    got = controls.word_stream_control(t, geom)
    assert controls.word_stream_control.launches == before + 1
    check_exact(got, controls.word_stream_control_plain(
        controls.word_rows(t, geom), geom))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,b", [((1920, 1080), 64), ((3840, 2160), 8),
                                    ((1000, 562), 3)])
@pytest.mark.parametrize("off", [0, 1, 4])
def test_cuda_sad_controls(dims, b, off):
    need_card()
    width, height = dims
    geom = GridGeometry.build(width, height, Config())
    luma = torch.randint(0, 256, (1 + b, height, width), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(b))
    luma = offset(luma.cuda(), off)
    check_exact(controls.sad_stream_control(luma, geom, 16),
                controls.sad_stream_control_plain(luma, 16))
    check_exact(controls.sad_compute_control(luma, geom, 16),
                controls.sad_compute_control_plain(luma, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,m,b", [((1920, 1080), 8192, 2048),
                                      ((3840, 2160), 16384, 64),
                                      ((7680, 4320), 8192, 16)])
@pytest.mark.parametrize("full", [False, True])
def test_cuda_mv_controls(dims, m, b, full):
    need_card()
    rng = np.random.default_rng(m + b)
    cfg = Config()
    geom = GridGeometry.build(*dims, cfg)
    mvs = as_payload(seeded_mvs(rng, b, m, *dims)).cuda()
    counts = np.full((b,), m, np.int32) if full else np.exp(
        rng.uniform(0, np.log(m), size=b)).astype(np.int32)
    counts[::7] = 0
    counts = torch.from_numpy(counts).cuda()
    check_exact(controls.mv_stream_control(mvs, counts),
                controls.mv_stream_control_plain(mvs, counts))
    args = (geom, mv_ops.threshold_bound(cfg.mv_threshold_sq),
            cfg.vectors_needed, cfg.clusters_needed, cfg.block_shift)
    for c in (counts, torch.roll(counts, -1)):
        got, motion = controls.mv_compute_control(mvs, c, *args)
        want, want_motion = controls.mv_compute_control_plain(mvs, c, *args)
        check_exact(got, want)
        assert torch.equal(motion.cpu(), want_motion.cpu())


@pytest.mark.cuda
def test_cuda_graph_captures_a_product_op_like_eager_calls():
    """K1 captured in a CUDA graph gives the eager calls' outputs, and the
    capture counts one launch a captured call (replays none)."""
    need_card()
    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    rng = np.random.default_rng(3)
    inputs = [torch.from_numpy(random_bits(rng, 750, geom)).cuda()
              for _ in range(3)]
    eager = [cluster_ops.cluster_bits_op(t, geom, cfg.clusters_needed)[0]
             for t in inputs]
    torch.cuda.synchronize()
    before = cluster_ops.cluster_words_op.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [cluster_ops.cluster_bits_op(inputs[i % 3], geom,
                                            cfg.clusters_needed)[0]
                for i in range(5)]
    assert cluster_ops.cluster_words_op.launches == before + 5
    for _ in range(2):
        for o in outs:
            o.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        for i, o in enumerate(outs):
            assert torch.equal(o, eager[i % 3])
    assert cluster_ops.cluster_words_op.launches == before + 5
    per_input = [int(e.sum()) for e in eager]
    t = audit.graph_time(lambda x: cluster_ops.cluster_bits_op(
        x, geom, cfg.clusters_needed)[0], inputs, 7, per_input, 2)
    assert t["checksum_ok"] and len(t["runs_us"]) == 2
