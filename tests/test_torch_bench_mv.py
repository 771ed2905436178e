"""C6-C10 of the port's bench (``mvtrim_tpu_torch/bench/controls.py``)
against ``benchmarks/mv_bench.py``'s TPU controls.

* Each plain version against its ``mv_bench.build_variant`` variant
  (``ctrl``, ``ctrlsub``, ``ctrlmm``, ``noclu``, ``mmctrl``; one buffer, one
  pass, one frame a step) run in Pallas's TPU interpret mode on the same
  seeded numpy fields, at M = 256 and 1000 and at 1920x1080 and 320x240
  (whose padded grids differ), counts 0, 1, M, above M and a sparse draw.
  ``benchmarks/mv_bench.py`` is loaded by path, nothing in it edited.
* NumPy statements: C6-C8 read the slots at or past the count, C8 masks
  negative fields to their low byte, C9 clamps counts above M, C10 wraps
  to int32 at an 8K grid.
* The wrappers' checks, the audit's tensor-rate bound and gate, and the mv
  family's cells on the CPU.
* The counts that stress C3's and C9's launch (a frame to a CTA of a
  persistent grid): a batch all at zero, one frame at M among zeros,
  negative counts, counts above M;
  C9's plain version against ``noclu``, C3's against ``ctrl`` at full
  counts (the only counts where they agree) and against a NumPy statement
  of its formula at the others.
* ``cuda``-marked: each kernel against its plain version at 1080p and 4K,
  sparse and full, C9 with the global histogram (7680x4320), C3 and C9 at
  the launch's edge counts (B = 1 and 3, an odd M, a base 8 bytes off,
  more frames than the grid's CTAs), and C10 at all-ones parity and M =
  16,384 (``python -m pytest -m cuda tests/test_torch_bench_mv.py`` on a
  card).

Every comparison is exact: the functions are integer.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu_torch.bench import audit, controls
from mvtrim_tpu_torch.bench import mv as mv_family
from mvtrim_tpu_torch.core.config import Config
from mvtrim_tpu_torch.core.types import GridGeometry
from mvtrim_tpu_torch.ops import mv_vote as mv_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = [(1920, 1080), (320, 240)]


@pytest.fixture(scope="module")
def mv_bench():
    spec = importlib.util.spec_from_file_location(
        "mv_bench_reference_c6", os.path.join(REPO, "benchmarks/mv_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_mvs(rng, b: int, m: int, width: int, height: int):
    """int32 (dst_x, dst_y, src_x, src_y) [b, m] as mv_bench.py draws
    them, within int16."""
    dst_x = rng.integers(-32, width + 32, size=(b, m)).astype(np.int32)
    dst_y = rng.integers(-32, height + 32, size=(b, m)).astype(np.int32)
    src_x = (dst_x - rng.integers(-8, 9, size=(b, m))).astype(np.int32)
    src_y = (dst_y - rng.integers(-8, 9, size=(b, m))).astype(np.int32)
    return dst_x, dst_y, src_x, src_y


def as_payload(fields) -> torch.Tensor:
    return torch.from_numpy(np.stack(fields, axis=2).astype(np.int16))


def seeded_counts(rng, m: int) -> np.ndarray:
    """0, 1, M, above M, and a sparse draw (log-uniform in 1..M)."""
    sparse = int(np.exp(rng.uniform(0, np.log(m))))
    return np.array([0, 1, m, m + 7, sparse], np.int32)


def port_variant(variant: str, mvs: torch.Tensor, counts: torch.Tensor,
                 geom: GridGeometry, sub: torch.Tensor):
    """The port's wrapper of a variant (the plain version on the CPU) and
    its plain version, on the same inputs."""
    cfg = Config()
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    if variant == "ctrl":
        return (controls.mv_capacity_control(mvs, counts),
                controls.mv_capacity_control_plain(mvs, counts))
    if variant == "ctrlsub":
        return (controls.mv_capacity_control_sub(mvs, counts, sub),
                controls.mv_capacity_control_sub_plain(mvs, counts, sub))
    if variant == "ctrlmm":
        return (controls.mv_capacity_control_mm(mvs, counts),
                controls.mv_capacity_control_mm_plain(mvs, counts))
    if variant == "noclu":
        return (controls.mv_votes_control(mvs, counts, geom, bound,
                                          cfg.block_shift),
                controls.mv_votes_control_plain(mvs, counts, geom, bound,
                                                cfg.block_shift))
    assert variant == "mmctrl"
    return (controls.mv_matrix_control(mvs, geom),
            controls.mv_matrix_control_plain(mvs, geom))


# --- each plain version against its TPU variant in interpret mode ---

@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("m", [256, 1000])
@pytest.mark.parametrize("variant", ["ctrl", "ctrlsub", "ctrlmm", "noclu",
                                     "mmctrl"])
def test_control_matches_the_jax_variant(mv_bench, variant, m, dims):
    width, height = dims
    rng = np.random.default_rng(m + width)
    counts = seeded_counts(rng, m)
    b = len(counts)
    fields = seeded_mvs(rng, b, m, width, height)
    jgeom = JaxGeometry.build(width, height, JaxConfig())
    with pltpu.force_tpu_interpret_mode():
        run = mv_bench.build_variant(variant, jgeom, JaxConfig(), k=1, b=b,
                                     m=m, iters=1, fps=1)
        want = np.asarray(run(*(f.reshape(b, 1, m) for f in fields),
                              fields[0].reshape(b, m, 1), counts))
    geom = GridGeometry.build(width, height, Config())
    assert (geom.padded_gh, geom.padded_gw) == (jgeom.padded_gh,
                                                jgeom.padded_gw)
    mvs = as_payload(fields)
    sub = torch.from_numpy(fields[0].astype(np.int16))
    got, plain = port_variant(variant, mvs, torch.from_numpy(counts), geom,
                              sub)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b,)


# --- C3's and C9's edge counts, against the TPU variants ---

EDGES = ("all zero", "one frame at M among zeros", "negative counts",
            "counts above M")


def edge_counts(pattern: str, m: int, rng, b: int = 5) -> np.ndarray:
    """b frames' counts at one of the EDGES patterns (or "sparse",
    "full"), the rest log-uniform in 1..M."""
    counts = np.exp(rng.uniform(0, np.log(m), size=b)).astype(np.int32)
    if pattern == "all zero":
        counts[:] = 0
    elif pattern == "one frame at M among zeros":
        counts[:] = 0
        counts[b // 2] = m
    elif pattern == "negative counts":
        counts[0::5] = -7
        counts[3::5] = -2 ** 31
    elif pattern == "counts above M":
        counts[1::5] = m + 1
        counts[4::5] = 2 ** 31 - 1
    elif pattern == "full":
        counts[:] = m
    else:
        assert pattern == "sparse"
    return counts


def jax_variant(mv_bench, variant, fields, counts, width, height):
    b, m = fields[0].shape
    jgeom = JaxGeometry.build(width, height, JaxConfig())
    with pltpu.force_tpu_interpret_mode():
        run = mv_bench.build_variant(variant, jgeom, JaxConfig(), k=1, b=b,
                                     m=m, iters=1, fps=1)
        return np.asarray(run(*(f.reshape(b, 1, m) for f in fields),
                              fields[0].reshape(b, m, 1), counts))


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("m", [256, 1000])
@pytest.mark.parametrize("pattern", EDGES)
def test_votes_control_matches_noclu_at_edge_counts(mv_bench, pattern, m,
                                                        dims):
    width, height = dims
    rng = np.random.default_rng(m + width + len(pattern))
    counts = edge_counts(pattern, m, rng)
    fields = seeded_mvs(rng, len(counts), m, width, height)
    want = jax_variant(mv_bench, "noclu", fields, counts, width, height)
    got, plain = port_variant("noclu", as_payload(fields),
                              torch.from_numpy(counts),
                              GridGeometry.build(width, height, Config()),
                              None)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want)
    if pattern in ("all zero", "negative counts"):
        assert (want[counts <= 0] == 0).all()


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("m", [256, 1000])
def test_stream_control_matches_ctrl_at_full_counts(mv_bench, m, dims):
    """C3 reads the rows below the count; at full counts that is every
    slot, which mv_bench.py's ctrl reads."""
    width, height = dims
    rng = np.random.default_rng(m + width)
    counts = edge_counts("full", m, rng)
    fields = seeded_mvs(rng, len(counts), m, width, height)
    want = jax_variant(mv_bench, "ctrl", fields, counts, width, height)
    mvs, c = as_payload(fields), torch.from_numpy(counts)
    np.testing.assert_array_equal(
        controls.mv_stream_control_plain(mvs, c).numpy(), want)
    np.testing.assert_array_equal(controls.mv_stream_control(mvs, c).numpy(),
                                  want)


def numpy_stream(fields, counts) -> np.ndarray:
    """count[b] + the four fields' sum over k < clamp(count[b], 0, M),
    wrapped to int32."""
    m = fields[0].shape[1]
    live = np.arange(m)[None, :] < np.clip(counts, 0, m)[:, None].astype(
        np.int64)
    total = sum((f.astype(np.int64) * live).sum(axis=1) for f in fields)
    total = total + counts.astype(np.int64)
    return ((total + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


@pytest.mark.parametrize("b", [1, 3, 5])
@pytest.mark.parametrize("pattern", EDGES + ("sparse", "full"))
def test_stream_control_plain_is_its_formula_at_edge_counts(pattern, b):
    rng = np.random.default_rng(b + len(pattern))
    m = 300
    counts = edge_counts(pattern, m, rng)[:b]
    fields = seeded_mvs(rng, b, m, 1920, 1080)
    mvs, c = as_payload(fields), torch.from_numpy(counts)
    want = numpy_stream(fields, counts)
    np.testing.assert_array_equal(
        controls.mv_stream_control_plain(mvs, c).numpy(), want)
    np.testing.assert_array_equal(controls.mv_stream_control(mvs, c).numpy(),
                                  want)


def test_stream_control_wraps_to_int32():
    m = 40000
    mvs = torch.full((2, m, 4), 32767, dtype=torch.int16)
    counts = torch.tensor([m, 2 ** 31 - 1], dtype=torch.int32)
    total = np.array([4 * m * 32767 + m, 4 * m * 32767 + 2 ** 31 - 1],
                     np.int64)
    want = (total + 2 ** 31) % 2 ** 32 - 2 ** 31
    np.testing.assert_array_equal(
        controls.mv_stream_control(mvs, counts).numpy(), want)


# --- against NumPy statements ---

@pytest.mark.parametrize("variant", ["ctrl", "ctrlsub", "ctrlmm"])
def test_capacity_controls_read_every_slot(variant):
    """The count is added, never a bound: slots at or past it count."""
    rng = np.random.default_rng(11)
    m = 300
    counts = np.array([0, 1, 17, 299, 300, 450, -4], np.int32)
    b = len(counts)
    fields = seeded_mvs(rng, b, m, 1920, 1080)
    geom = GridGeometry.build(1920, 1080, Config())
    got, _ = port_variant(variant, as_payload(fields),
                          torch.from_numpy(counts), geom,
                          torch.from_numpy(fields[0].astype(np.int16)))
    f64 = [f.astype(np.int64) for f in fields]
    if variant == "ctrlmm":
        want = sum((f & 255).sum(axis=1) for f in f64)
    else:
        want = sum(f.sum(axis=1) for f in f64)
    if variant == "ctrlsub":
        want = want + f64[0].sum(axis=1)
    np.testing.assert_array_equal(got.numpy(), want + counts)


def test_capacity_mm_control_masks_negative_fields_to_the_low_byte():
    assert -3 & 255 == 253
    m = 64
    mvs = torch.full((2, m, 4), -3, dtype=torch.int16)
    mvs[1, :, 2] = -256                       # low byte 0
    mvs[1, :, 3] = 32767                      # low byte 255
    counts = torch.tensor([5, 0], dtype=torch.int32)
    got = controls.mv_capacity_control_mm(mvs, counts).tolist()
    assert got == [4 * 253 * m + 5, (253 + 253 + 0 + 255) * m]
    assert controls.mv_capacity_control(mvs, counts).tolist()[0] == \
        -12 * m + 5


def test_capacity_mm_exact_limit_of_the_jax_control():
    """mv_bench.py's ctrlmm sums in float32: exact while 4 * 255 * M <
    2^24.  The port's integer sum stays exact past it."""
    assert 4 * 255 * controls.MM_EXACT_M < 2 ** 24
    assert 4 * 255 * (controls.MM_EXACT_M + 1) >= 2 ** 24
    assert 16384 <= controls.MM_EXACT_M       # the bench's 4K capacity
    m = 40000
    mvs = torch.full((1, m, 4), 255, dtype=torch.int16)
    got = controls.mv_capacity_control_mm(
        mvs, torch.zeros(1, dtype=torch.int32))
    assert got.tolist() == [4 * 255 * m]
    assert 4 * 255 * m > 2 ** 24 and 4 * 255 * m + 1 != float(
        np.float32(4 * 255 * m + 1))


def test_capacity_control_wraps_to_int32():
    m = 40000
    mvs = torch.full((1, m, 4), 32767, dtype=torch.int16)
    counts = torch.tensor([3], dtype=torch.int32)
    total = 4 * m * 32767 + 3
    want = (total + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert controls.mv_capacity_control(mvs, counts).tolist() == [want]
    sub = torch.full((1, m), 32767, dtype=torch.int16)
    total += m * 32767
    want = (total + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert controls.mv_capacity_control_sub(mvs, counts, sub).tolist() == \
        [want]


def numpy_kept(fields, counts, geom, bound, shift) -> np.ndarray:
    dst_x, dst_y, src_x, src_y = (f.astype(np.int64) for f in fields)
    m = dst_x.shape[1]
    mag = (dst_x - src_x) ** 2 + (dst_y - src_y) ** 2
    gx, gy = dst_x >> shift, dst_y >> shift
    keep = ((np.arange(m)[None, :] < np.clip(counts, 0, m)[:, None])
            & (mag >= bound) & (gx >= 0) & (gx < geom.gw)
            & (gy >= geom.y_min) & (gy < geom.y_max))
    return keep.sum(axis=1)


def test_votes_control_clamps_counts_above_m():
    cfg = Config()
    geom = GridGeometry.build(1920, 1080, cfg)
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    rng = np.random.default_rng(3)
    m = 400
    counts = np.array([m + 100, 2 ** 31 - 1, -5, 0, m, 123], np.int32)
    fields = seeded_mvs(rng, len(counts), m, 1920, 1080)
    got = controls.mv_votes_control(as_payload(fields),
                                    torch.from_numpy(counts), geom, bound,
                                    cfg.block_shift).numpy()
    want = numpy_kept(fields, counts, geom, bound, cfg.block_shift)
    np.testing.assert_array_equal(got, want)
    clamped = controls.mv_votes_control(
        as_payload(fields), torch.from_numpy(np.clip(counts, 0, m)), geom,
        bound, cfg.block_shift).numpy()
    np.testing.assert_array_equal(got, clamped)
    assert got[0] > 0 and got[1] > 0 and got[2] == got[3] == 0


def test_votes_control_is_the_sum_of_the_votes():
    """C9 counts the votes K4+K5's scatter casts (``mv_votes_plain``)."""
    cfg = Config()
    geom = GridGeometry.build(320, 240, cfg)
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    rng = np.random.default_rng(8)
    counts = np.array([0, 5, 100, 250], np.int32)
    mvs = as_payload(seeded_mvs(rng, 4, 250, 320, 240))
    c = torch.from_numpy(counts)
    votes = mv_ops.mv_votes_plain(mvs, c, geom, bound, cfg.block_shift)
    np.testing.assert_array_equal(
        controls.mv_votes_control(mvs, c, geom, bound,
                                  cfg.block_shift).numpy(),
        votes.sum(dim=(1, 2)).numpy())


def test_matrix_control_wraps_at_an_8k_grid():
    geom = GridGeometry.build(7680, 4320, Config())
    assert (geom.padded_gh, geom.padded_gw) == (272, 512)
    m = 16384
    assert 512 * 272 * m > 2 ** 31
    mvs = torch.zeros((2, m, 4), dtype=torch.int16)
    mvs[0, :, 0] = 1                          # dst_x ^ src_x = 1
    mvs[0, :, 1] = 1                          # dst_y ^ src_y = 1
    mvs[1, ::2, 0] = mvs[1, ::2, 1] = 3       # half the slots
    total = np.array([512 * 272 * m, 512 * 272 * (m // 2)], np.int64)
    want = (total + 2 ** 31) % 2 ** 32 - 2 ** 31
    np.testing.assert_array_equal(
        controls.mv_matrix_control(mvs, geom).numpy(), want)


def test_matrix_ops_round_m_up_to_the_mma_depth():
    geom = GridGeometry.build(1920, 1080, Config())
    assert controls.matrix_ops(geom, 2048, 8192) == \
        2 * 72 * 128 * 8192 * 2048
    assert controls.matrix_ops(geom, 1, 1000) == 2 * 72 * 128 * 1024
    assert controls.matrix_ops(geom, 3, 32) == 2 * 72 * 128 * 32 * 3


# --- the wrappers' checks ---

def test_new_controls_raise_on_other_devices_and_bad_inputs():
    geom = GridGeometry.build(320, 240, Config())
    meta = torch.empty((2, 8, 4), dtype=torch.int16, device="meta")
    meta_counts = torch.empty((2,), dtype=torch.int32, device="meta")
    calls = {
        "mv_capacity_control": lambda f, c, s: controls.mv_capacity_control(
            f, c),
        "mv_capacity_control_sub": controls.mv_capacity_control_sub,
        "mv_capacity_control_mm":
            lambda f, c, s: controls.mv_capacity_control_mm(f, c),
        "mv_votes_control": lambda f, c, s: controls.mv_votes_control(
            f, c, geom, 16, 4),
        "mv_matrix_control": lambda f, c, s: controls.mv_matrix_control(
            f, geom),
    }
    assert set(calls) <= set(controls.CONTROLS)
    good = torch.zeros((2, 8, 4), dtype=torch.int16)
    counts = torch.zeros((2,), dtype=torch.int32)
    sub = torch.zeros((2, 8), dtype=torch.int16)
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda or cpu"):
            call(meta, meta_counts,
                 torch.empty((2, 8), dtype=torch.int16, device="meta"))
        with pytest.raises(ValueError):
            call(torch.zeros((2, 8, 3), dtype=torch.int16), counts, sub)
        with pytest.raises(TypeError):
            call(torch.zeros((2, 8, 4), dtype=torch.int32), counts, sub)
        if name != "mv_matrix_control":
            with pytest.raises(ValueError):
                call(good, torch.zeros((3,), dtype=torch.int32), sub)
        assert call(good, counts, sub).tolist() == [0, 0]
    with pytest.raises(TypeError):
        controls.mv_capacity_control_sub(good, counts, sub.to(torch.int32))
    with pytest.raises(ValueError):
        controls.mv_capacity_control_sub(good, counts, sub[:, :7])
    with pytest.raises(ValueError):
        controls.mv_capacity_control_sub(good, counts,
                                         sub.t().contiguous().t())
    with pytest.raises(ValueError):
        controls.mv_capacity_control_sub(
            good, counts, torch.empty((2, 8), dtype=torch.int16,
                                      device="meta"))


# --- the audit with the tensor rate ---

def test_least_time_takes_the_rate_of_the_operations():
    geom = GridGeometry.build(1920, 1080, Config())
    b, m = 2048, 8192
    ops = controls.matrix_ops(geom, b, m)
    t = audit.least_time(b * m * 8, ops, audit.TENSOR_INT8_OPS_PER_S)
    assert t["bound_by"] == "operations"
    assert t["bound_ms"] == pytest.approx(ops / 1979e12 * 1e3)
    assert 150e-3 < t["bound_ms"] < 160e-3    # 156 µs
    # the default rate stays the CUDA cores' 32-bit one
    assert audit.least_time(0, 67e9)["bound_ms"] == pytest.approx(1.0)


def test_gate_flags_an_operation_rate_over_the_peak():
    peak = audit.TENSOR_INT8_OPS_PER_S
    ok = audit.gate(1e-3, 1e6, True, ops=peak * 1e-3,
                    ops_per_s=peak)
    assert ok["valid"] and ok["pct_of_ops_peak"] == pytest.approx(100.0)
    skipped = audit.gate(1e-3, 1e6, True, ops=1.06 * peak * 1e-3,
                         ops_per_s=peak)
    assert not skipped["valid"] and skipped["pct_of_ops_peak"] > 105
    assert "implied_tops" not in audit.gate(1e-3, 1e6, True)


def test_measure_carries_the_bound_and_gates_operations(monkeypatch):
    run = audit.Run(device=torch.device("meta"), card="a card")
    monkeypatch.setattr(audit, "graph_time", lambda *a: {
        "runs_us": [100.0], "checksum_ok": True})
    monkeypatch.setattr(audit, "host_time", lambda *a: 1.0)
    peak = audit.TENSOR_INT8_OPS_PER_S
    m = audit.measure(run, None, [None], [0], n=1, nbytes=1e6, frames=1,
                      kernel=None, ops=0.5 * peak * 1e-4, ops_per_s=peak)
    assert m["valid"] and m["bound_by"] == "operations"
    assert m["bound_us"] == pytest.approx(50.0)
    m = audit.measure(run, None, [None], [0], n=1, nbytes=1e6, frames=1,
                      kernel=None, ops=2 * peak * 1e-4, ops_per_s=peak)
    assert not m["valid"] and m["us"] is None


# --- the mv family on the CPU ---

def test_mv_cells_carry_the_new_controls():
    run = audit.Run(device=torch.device("cpu"), card=audit.CPU_LABEL,
                    quick=True)
    cells = mv_family.run(run)
    assert [c["key"] for c in cells] == [
        f"{label} M={m} {mode}" for label, _, m, mode in mv_family.CELLS]
    full = ("capacity_sub_control", "capacity_mm_control", "matrix_control")
    for cell in cells:
        for name in ("kernel", "stream_control", "compute_control",
                     "capacity_control", "votes_control"):
            assert cell[name]["valid"] and cell[name]["checksum_ok"], name
        for name in full:
            assert (name in cell) == cell["key"].endswith("full"), name
        m = int(cell["key"].split("M=")[1].split()[0])
        b = cell["frames"]
        assert cell["capacity_control"]["nbytes"] == b * (m * 8 + 8)
        if cell["key"].endswith("full"):
            assert cell["capacity_sub_control"]["nbytes"] == \
                b * (m * 10 + 8)
            assert cell["matrix_control"]["bound_by"] == "operations"
            assert all(cell[name]["valid"] for name in full)


# --- on the card ---

def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_bench_mv.py)")


def check_exact(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu().to(torch.int64), want.cpu().to(torch.int64))


def card_case(dims, m, b, full):
    rng = np.random.default_rng(m + b)
    mvs = as_payload(seeded_mvs(rng, b, m, *dims)).cuda()
    counts = np.full((b,), m, np.int32) if full else np.exp(
        rng.uniform(0, np.log(m), size=b)).astype(np.int32)
    counts[::7] = 0
    counts[3::11] = m + 9
    return mvs, torch.from_numpy(counts).cuda()


def counted(wrapper, call):
    before = wrapper.launches
    out = call()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dims,m,b", [((1920, 1080), 8192, 2048),
                                      ((3840, 2160), 16384, 256),
                                      ((1000, 562), 1000, 33)])
@pytest.mark.parametrize("full", [False, True])
def test_cuda_new_controls(dims, m, b, full):
    need_card()
    cfg = Config()
    geom = GridGeometry.build(*dims, cfg)
    mvs, counts = card_case(dims, m, b, full)
    sub = mvs[..., 0].contiguous()
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    c = controls
    check_exact(counted(c.mv_capacity_control,
                        lambda: c.mv_capacity_control(mvs, counts)),
                c.mv_capacity_control_plain(mvs, counts))
    check_exact(counted(c.mv_capacity_control_sub,
                        lambda: c.mv_capacity_control_sub(mvs, counts, sub)),
                c.mv_capacity_control_sub_plain(mvs, counts, sub))
    check_exact(counted(c.mv_capacity_control_mm,
                        lambda: c.mv_capacity_control_mm(mvs, counts)),
                c.mv_capacity_control_mm_plain(mvs, counts))
    check_exact(counted(c.mv_votes_control, lambda: c.mv_votes_control(
        mvs, counts, geom, bound, cfg.block_shift)),
        c.mv_votes_control_plain(mvs, counts, geom, bound, cfg.block_shift))
    check_exact(counted(c.mv_matrix_control,
                        lambda: c.mv_matrix_control(mvs, geom)),
                c.mv_matrix_control_plain(mvs, geom))


@pytest.mark.cuda
def test_cuda_votes_control_with_the_global_histogram():
    need_card()
    cfg = Config()
    geom = GridGeometry.build(7680, 4320, cfg)
    mvs, counts = card_case((7680, 4320), 8192, 64, False)
    assert controls.votes_scratch_cells(64, geom, mvs.device.index or 0) > 0
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    counts[5] = 8192
    check_exact(controls.mv_votes_control(mvs, counts, geom, bound,
                                          cfg.block_shift),
                controls.mv_votes_control_plain(mvs, counts, geom, bound,
                                                cfg.block_shift))


def offset8(t: torch.Tensor) -> torch.Tensor:
    """t's values at a base 8 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() * 2 + 16, dtype=torch.uint8, device=t.device)
    start = (16 - buf.data_ptr() % 16) % 16 + 8
    return buf[start:start + t.numel() * 2].view(torch.int16).view(
        t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,m,b", [((1920, 1080), 8192, 2048),
                                      ((3840, 2160), 16384, 256),
                                      ((1920, 1080), 8192, 1),
                                      ((1920, 1080), 8192, 3),
                                      ((1920, 1080), 8191, 33),
                                      ((1920, 1080), 512, 5000),
                                      ((7680, 4320), 8192, 16)])
@pytest.mark.parametrize("pattern", EDGES + ("sparse", "full"))
def test_cuda_ragged_controls_at_edge_counts(dims, m, b, pattern):
    """C3 and C9 on their launch, exact, one launch a call: fewer frames
    than CTAs, an odd M and a base 8 bytes off (one MV a
    load), more frames than the grid's CTAs, 8K's global histogram."""
    need_card()
    cfg = Config()
    geom = GridGeometry.build(*dims, cfg)
    rng = np.random.default_rng(m + b + len(pattern))
    counts = edge_counts(pattern, m, rng, b)
    mvs = as_payload(seeded_mvs(rng, b, m, *dims)).cuda()
    c = torch.from_numpy(counts).cuda()
    bound = mv_ops.threshold_bound(cfg.mv_threshold_sq)
    bases = [mvs] + ([offset8(mvs)] if m % 2 == 0 else [])
    for base in bases:
        check_exact(counted(controls.mv_stream_control,
                            lambda: controls.mv_stream_control(base, c)),
                    controls.mv_stream_control_plain(base, c))
        check_exact(counted(controls.mv_votes_control,
                            lambda: controls.mv_votes_control(
                                base, c, geom, bound, cfg.block_shift)),
                    controls.mv_votes_control_plain(base, c, geom, bound,
                                                    cfg.block_shift))


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(1920, 1080), (3840, 2160), (7680, 4320)])
def test_cuda_matrix_control_is_integer_not_tf32(dims):
    """All-ones parity at M = 16,384: every cell of the product holds
    16,384, past float16's exact integers (2,048) and TF32's, and the
    int32 sum wraps at 8K; the tensor-core path is s8 x s8 -> s32."""
    need_card()
    geom = GridGeometry.build(*dims, Config())
    m, b = 16384, 3
    mvs = torch.zeros((b, m, 4), dtype=torch.int16, device="cuda")
    mvs[:, :, 0] = 1
    mvs[:, :, 1] = 1
    mvs[2, 5::7] = 0                          # one slot in 7 off
    ones = np.array([m, m, m - len(range(5, m, 7))], np.int64)
    total = ones * geom.padded_gh * geom.padded_gw
    want = torch.from_numpy((total + 2 ** 31) % 2 ** 32 - 2 ** 31)
    check_exact(controls.mv_matrix_control(mvs, geom), want)
    check_exact(controls.mv_matrix_control_plain(mvs, geom), want)
