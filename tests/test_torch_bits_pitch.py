"""The bits payload at its own byte pitch: ``cluster_bits_op`` and the
word-domain kernel's reading of rows, against the JAX package.

Seeded numpy masks, packed as the native scanner packs them, go through
the port's ``cluster_bits_op`` on CPU tensors (its plain version), the JAX
XLA build and the JAX transposed Pallas kernel in interpret mode (both fed
``repack_bits_words(bits)``, the layout they take) and the NumPy oracle.
A NumPy model of ``csrc/word_cluster.cu`` (its span split into an aligned
middle and plain head and tail, its unaligned word reads and its walk down
word columns) is held to the plain version at both pitches and at
misaligned bases.  Integer math throughout, so every comparison is exact.
The kernel itself is checked by the ``cuda``-marked test, which runs only
where a card is present (``python -m pytest -m cuda
tests/test_torch_bits_pitch.py``).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mvtrim_tpu.core import oracle
from mvtrim_tpu.core.types import GridGeometry as JaxGeometry
from mvtrim_tpu.ops import cluster as jax_cluster
from mvtrim_tpu_torch.core import Config, GridGeometry
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.ops import _build
from mvtrim_tpu_torch.ops import cluster as torch_cluster

GEOMETRIES = [
    ((1920, 1080), 0.05),   # gw=120: 15 B a row, 1,020 B a frame
    ((3840, 2160), 0.05),   # 4K
    ((360, 240), 0.0),      # margin 0; gw=23: one bit past gw a row
    ((200, 144), 0.05),     # gw=13: 2 B a row, 18 B a frame
    ((1024, 576), 0.05),    # gw=64
    ((512, 2048), 0.0),     # one word a row, margin 0
]
# gw % 8 != 0: the last byte of a row holds bits past gw
PARTIAL_BYTE = [
    ((360, 240), 0.0),      # gw=23
    ((200, 144), 0.05),     # gw=13
    ((1000, 562), 0.0),     # gw=63
    ((100, 100), 0.0),      # gw=7: 1 B a row, 7 B a frame
    ((1928, 1080), 0.05),   # gw=121: 16 B a row, 7 bits past gw
]
MASK32 = 0xFFFFFFFF


def jx(geom):
    return JaxGeometry(**dataclasses.asdict(geom))


def geometry(dims, vm):
    cfg = Config(vertical_mask=vm)
    return cfg, GridGeometry.build(dims[0], dims[1], cfg)


def masks(seed, b, geom):
    """bool [b, gh, gw]: dense (0.3) and sparse (0.002) frames alternate."""
    rng = np.random.default_rng(seed)
    density = np.where(np.arange(b) % 2 == 0, 0.3, 0.002)[:, None, None]
    return rng.random((b, geom.gh, geom.gw)) < density


def packed(active):
    return np.packbits(active, axis=2, bitorder="little")


def with_junk(bits, geom, seed):
    """bits with random values in every bit past gw of each row's last
    byte (what a scanner that left them unmasked would send)."""
    spare = 8 * bits.shape[2] - geom.gw
    junk = np.random.default_rng(seed).integers(
        0, 256, size=bits.shape[:2], dtype=np.uint8)
    out = bits.copy()
    out[:, :, -1] |= junk & np.uint8((0xFF << (8 - spare)) & 0xFF)
    return out


def oracle_counts(active, geom):
    return oracle.count_clusters_batch(
        active.astype(np.uint8), vectors_needed=1,
        y_min=geom.y_min, y_max=geom.y_max)


@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize("dims,vm", GEOMETRIES)
class TestAgainstJax:
    def test_bits_op_matches_xla_and_oracle(self, dims, vm, b):
        cfg, geom = geometry(dims, vm)
        active = masks(dims[0] + b, b, geom)
        bits = packed(active)
        words = jax_cluster.repack_bits_words(bits, jx(geom))
        _, used, lanes = jax_cluster.word_geometry(jx(geom))
        padded = np.zeros((b, lanes), np.int32)
        padded[:, :used] = words
        xla_counts, xla_motion = jax_cluster.make_cluster_words_op_xla(
            jx(geom), cfg.clusters_needed)(jnp.asarray(padded))
        counts, motion = torch_cluster.cluster_bits_op(
            torch.from_numpy(bits), geom, cfg.clusters_needed)
        expect = oracle_counts(active, geom)
        assert counts.dtype == torch.int32 and motion.dtype == torch.bool
        np.testing.assert_array_equal(counts.numpy(), expect)
        np.testing.assert_array_equal(np.asarray(xla_counts), expect)
        np.testing.assert_array_equal(np.asarray(xla_motion), motion.numpy())
        np.testing.assert_array_equal(
            motion.numpy(),
            expect >= oracle.effective_clusters_needed(cfg.clusters_needed))

    def test_bits_op_matches_pallas_transposed(self, dims, vm, b):
        """The TPU kernel this kernel replaces, in interpret mode, on the
        repacked words of the same bits."""
        cfg, geom = geometry(dims, vm)
        bits = packed(masks(dims[1] + b, b, geom))
        words = jax_cluster.repack_bits_words(bits, jx(geom))
        _, used, lanes = jax_cluster.word_geometry(jx(geom))
        wt = np.zeros((lanes, b), np.int32)
        wt[:used] = words.T
        op = jax_cluster.make_cluster_words_op_pallas_T(
            jx(geom), cfg.clusters_needed, block_b=b, interpret=True)
        pallas_counts, pallas_motion = op(jnp.asarray(wt))
        counts, motion = torch_cluster.cluster_bits_op(
            torch.from_numpy(bits), geom, cfg.clusters_needed)
        np.testing.assert_array_equal(np.asarray(pallas_counts),
                                      counts.numpy())
        np.testing.assert_array_equal(np.asarray(pallas_motion),
                                      motion.numpy())


@pytest.mark.parametrize("dims,vm", PARTIAL_BYTE)
def test_bits_past_gw_leave_the_counts_unchanged(dims, vm):
    """Bits set past gw in a row's last byte never reach a centre cell:
    the plain version, the JAX build on the repacked words (which carry
    them) and the kernel model all count as without them."""
    cfg, geom = geometry(dims, vm)
    active = masks(dims[0], 7, geom)
    bits = packed(active)
    expect = oracle_counts(active, geom)
    for seed in range(4):
        dirty = with_junk(bits, geom, seed)
        assert not np.array_equal(dirty, bits)
        counts, _ = torch_cluster.cluster_bits_op(
            torch.from_numpy(dirty), geom, cfg.clusters_needed)
        np.testing.assert_array_equal(counts.numpy(), expect)
        words = jax_cluster.repack_bits_words(dirty, jx(geom))
        _, used, lanes = jax_cluster.word_geometry(jx(geom))
        padded = np.zeros((7, lanes), np.int32)
        padded[:, :used] = words
        xla_counts, _ = jax_cluster.make_cluster_words_op_xla(
            jx(geom), cfg.clusters_needed)(jnp.asarray(padded))
        np.testing.assert_array_equal(np.asarray(xla_counts), expect)
        np.testing.assert_array_equal(
            kernel_model(dirty, geom, frames=3, offset=seed), expect)


# --- a NumPy model of csrc/word_cluster.cu ---

def center_bits(c, gw):
    x0 = 32 * c
    k_lo, k_hi = max(0, 1 - x0), min(31, gw - 2 - x0)
    if k_hi < k_lo:
        return 0
    return ((1 << (k_hi + 1)) - 1) & (MASK32 << k_lo) & MASK32


def cluster_bits(w, prev, nxt, up, down):
    left = ((w << 1) & MASK32) | (prev >> 31)
    right = (w >> 1) | ((nxt << 31) & MASK32)
    return w & (left | right | up | down)


def model_shape(y_lo, y_hi, gww):
    """count_frame's split of a frame's centre rows over the 32 lanes of
    its warp: (lanes, bands, rows a band)."""
    bands = 32 // gww if gww <= 32 else 1
    return 32, bands, -(-(y_hi - y_lo) // bands)


def model_count_frame(word, byte, base, gh, pitch, gw, y_lo, y_hi, shape):
    """count_frame summed over a frame's warp: lane t walks word column
    t % gww down band t // gww of the rows, reading a word and two edge
    bytes a row."""
    threads, bands, band_rows = shape
    gww = (gw + 31) // 32
    total = 0
    for t in range(threads):
        narrow = gww <= threads
        band = t // gww if narrow else 0
        y0 = y_lo + band * band_rows
        y1 = min(y0 + band_rows, y_hi)
        if band >= bands or y0 >= y1:
            continue
        for c in range(t - band * gww if narrow else t, gww, threads):
            avail = pitch - 4 * c
            assert avail >= 1
            keep = MASK32 if avail >= 4 else (1 << (8 * avail)) - 1
            center = center_bits(c, gw)
            o = base + y0 * pitch + 4 * c
            up = word(o - pitch) if y0 > 0 else 0
            w = word(o) & keep
            for y in range(y0, y1):
                down = word(o + pitch) if y + 1 < gh else 0
                prev = byte(o - 1) << 24 if c > 0 else 0
                nxt = byte(o + 4) if avail > 4 else 0
                total += bin(cluster_bits(w, prev, nxt, up, down)
                             & center).count("1")
                up, w = w, down & keep
                o += pitch
    return total


def kernel_model(rows, geom, *, frames, offset=0, rng_seed=0):
    """counts [B] as the kernel computes them, with `frames` frames a CTA,
    from rows uint8 [B, gh, pitch] placed `offset` bytes past a 16-byte
    boundary of device memory.  Shared memory starts as garbage, and the
    span's three pieces are read from the tensor only."""
    b, gh, pitch = rows.shape
    frame_bytes = gh * pitch
    flat = rows.reshape(-1)
    rng = np.random.default_rng(rng_seed)
    y_lo = max(geom.y_min, 0)
    y_hi = max(y_lo, min(geom.y_max, gh))
    shape = model_shape(y_lo, y_hi, (geom.gw + 31) // 32)
    out = []
    for f0 in range(0, b, frames):
        nf = min(frames, b - f0)
        start = f0 * frame_bytes            # the span, in the tensor
        length = nf * frame_bytes
        head = (offset + start) % 16        # its address mod 16
        a = min((16 - head) & 15, length)
        d = max(a, ((head + length) & ~15) - head)
        # an empty middle (a span that ends before a 16-byte boundary)
        # issues no copy
        assert d == a or ((head + a) % 16 == 0 and (d - a) % 16 == 0)
        assert a <= d <= length
        assert start + length <= flat.size
        smem = rng.integers(0, 256, size=16 + 16 + length + 16,
                            dtype=np.uint8)
        data = smem[16:]
        data[head + a:head + d] = flat[start + a:start + d]  # bulk copy
        data[head:head + a] = flat[start:start + a]          # plain head
        data[head + d:head + length] = flat[start + d:start + length]
        w32 = data[:len(data) // 4 * 4].view("<u4")

        def word(o):
            o += head
            pair = int(w32[o >> 2]) | (int(w32[(o >> 2) + 1]) << 32)
            return (pair >> (8 * (o & 3))) & MASK32

        def byte(o):
            return int(data[head + o])

        for k in range(nf):
            out.append(model_count_frame(word, byte, k * frame_bytes, gh,
                                         pitch, geom.gw, y_lo, y_hi, shape))
    return np.array(out, np.int64)


def rows_of(payload, bits, geom):
    if payload == "bits":
        return bits
    words = torch_cluster.repack_bits_words(bits, geom)
    return words.view(np.uint8).reshape(bits.shape[0], geom.gh, -1)


@pytest.mark.parametrize("payload", ["bits", "words"])
@pytest.mark.parametrize("dims,vm", GEOMETRIES + PARTIAL_BYTE[2:])
def test_kernel_model_matches_plain(dims, vm, payload):
    """The kernel's span split, unaligned reads and column walk, at 1, 3
    and 32 frames a CTA and bases 0, 1, 7 and 13 bytes past a 16-byte
    boundary (bits) or 0, 4 and 12 (words), count what the plain version
    counts."""
    cfg, geom = geometry(dims, vm)
    b = 3 if geom.gh * geom.gw > 20000 else 7
    active = masks(dims[0] * 3 + b, b, geom)
    rows = rows_of(payload, packed(active), geom)
    expect = oracle_counts(active, geom)
    offsets = (0, 1, 7, 13) if payload == "bits" else (0, 4, 12)
    for frames in (1, 3, 32):
        for offset in offsets:
            np.testing.assert_array_equal(
                kernel_model(rows, geom, frames=frames, offset=offset,
                             rng_seed=offset), expect)


def test_bands_cover_every_centre_word_once():
    """count_frame's split of the centre rows over a warp, at every word
    count a row can have up to 40 and row counts 0 to 130: each (row,
    column) is walked exactly once."""
    for gww in range(1, 41):
        for rows in range(0, 131):
            lanes, bands, band_rows = model_shape(0, rows, gww)
            seen = np.zeros((rows, gww), np.int64)
            for t in range(lanes):
                narrow = gww <= lanes
                band = t // gww if narrow else 0
                y0 = band * band_rows
                y1 = min(y0 + band_rows, rows)
                if band >= bands or y0 >= y1:
                    continue
                start = t - band * gww if narrow else t
                for c in range(start, gww, lanes):
                    seen[y0:y1, c] += 1
            assert (seen == 1).all(), (gww, rows)


@pytest.mark.parametrize("dims", [(640, 480), (1920, 1080), (200, 144)])
def test_scan_bits_matches_scan_words_and_oracle(dims):
    """The torch backend's bits dispatch (no repack) decides as its words
    dispatch and as the oracle backend, over several dispatches."""
    cfg = Config(scan_backend="torch", device_batch=16)
    det = MVClusterDetector(*dims, cfg)
    ref = MVClusterDetector(*dims, Config(scan_backend="oracle"))
    rng = np.random.default_rng(dims[0])
    density = rng.choice([0.0, 0.003, 0.05, 0.3], size=40)[:, None, None]
    active = rng.random((40, det.geom.gh, det.geom.gw)) < density
    bits = packed(active)
    words = torch_cluster.repack_bits_words(bits, det.geom)
    got = det.scan_bits_async(bits)()
    np.testing.assert_array_equal(got, det.scan_words_async(words)())
    np.testing.assert_array_equal(got, ref.scan_bits_async(bits)())
    assert got.any() and not got.all()


def test_scan_bits_dispatches_the_bits_as_they_come(monkeypatch):
    """No repack on the feeder: the op receives the uint8 rows."""
    det = MVClusterDetector(640, 480, Config(scan_backend="torch",
                                             device_batch=8))
    monkeypatch.setattr(torch_cluster, "repack_bits_words", None)
    seen = []
    real = torch_cluster.cluster_bits_op

    def spy(bits, geom, need):
        seen.append((bits.dtype, tuple(bits.shape)))
        return real(bits, geom, need)

    monkeypatch.setattr(torch_cluster, "cluster_bits_op", spy)
    bits = packed(masks(5, 10, det.geom))
    det.scan_bits(bits)
    assert seen == [(torch.uint8, (8, det.geom.gh, bits.shape[2])),
                    (torch.uint8, (2, det.geom.gh, bits.shape[2]))]


class TestWrapper:
    GEOM = GridGeometry.build(1920, 1080, Config())

    def test_cpu_tensor_runs_plain_and_counts_no_launch(self):
        before = torch_cluster.cluster_words_op.launches
        counts, motion = torch_cluster.cluster_bits_op(
            torch.zeros((3, 68, 15), dtype=torch.uint8), self.GEOM, 2)
        assert torch_cluster.cluster_words_op.launches == before
        assert counts.tolist() == [0, 0, 0] and not motion.any()

    def test_empty_batch(self):
        counts, motion = torch_cluster.cluster_bits_op(
            torch.zeros((0, 68, 15), dtype=torch.uint8), self.GEOM, 2)
        assert counts.shape == motion.shape == (0,)

    @pytest.mark.parametrize("dims,vm", GEOMETRIES + PARTIAL_BYTE)
    def test_bits_to_words_is_the_repack(self, dims, vm):
        _, geom = geometry(dims, vm)
        bits = with_junk(packed(masks(dims[1], 3, geom)), geom, 1)
        words = torch_cluster.bits_to_words(torch.from_numpy(bits), geom)
        assert words.dtype == torch.int32
        np.testing.assert_array_equal(
            words.numpy(), torch_cluster.repack_bits_words(bits, geom))

    def test_plain_equals_words_plain_on_the_repack(self):
        bits = packed(masks(9, 5, self.GEOM))
        words = torch_cluster.repack_bits_words(bits, self.GEOM)
        assert torch.equal(
            torch_cluster.bits_cluster_counts_plain(torch.from_numpy(bits),
                                                    self.GEOM),
            torch_cluster.word_cluster_counts_plain(torch.from_numpy(words),
                                                    self.GEOM))

    @pytest.mark.parametrize("bad", ["dtype", "rows", "pitch", "dims",
                                     "stride", "device"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        bits = torch.zeros((4, 68, 15), dtype=torch.uint8)
        if bad == "dtype":
            bits = bits.to(torch.int32)
        elif bad == "rows":
            bits = torch.zeros((4, 67, 15), dtype=torch.uint8)
        elif bad == "pitch":
            bits = torch.zeros((4, 68, 16), dtype=torch.uint8)
        elif bad == "dims":
            bits = torch.zeros((4, 68 * 15), dtype=torch.uint8)
        elif bad == "stride":
            bits = torch.zeros((15, 68, 4), dtype=torch.uint8).permute(
                2, 1, 0)
        else:
            bits = bits.to("meta")
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            torch_cluster.cluster_bits_op(bits, self.GEOM, 2)

    def test_outputs_on_the_device_of_the_input(self):
        counts, motion = torch_cluster.outputs(
            torch.zeros((2, 3), dtype=torch.uint8), 6)
        assert counts.dtype == torch.int32 and counts.shape == (6,)
        assert motion.dtype == torch.bool and motion.shape == (6,)
        assert counts.device == motion.device == torch.device("cpu")


class TestLaunchHelper:
    """``_build.launch`` with a stand-in C entry point: the arguments,
    then the device index and the current stream; a nonzero code raises
    and is not counted."""

    class Counted:
        launches = 0

    def setup(self, monkeypatch, code):
        calls = []

        def entry(*args):
            calls.append(args)
            return code

        monkeypatch.setitem(_build._entries, "mvt_fake", entry)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda index: 1000 + index, raising=False)
        return calls

    def test_passes_device_and_stream_and_counts(self, monkeypatch):
        calls = self.setup(monkeypatch, 0)
        counter = self.Counted()
        _build.launch("mvt_fake", counter, torch.device("cuda", 3), 11, 12)
        _build.launch("mvt_fake", counter, torch.device("cuda", 0), 13)
        assert calls == [(11, 12, 3, 1003), (13, 0, 1000)]
        assert counter.launches == 2

    def test_error_raises_uncounted(self, monkeypatch):
        self.setup(monkeypatch, 7)
        counter = self.Counted()
        with pytest.raises(RuntimeError, match="CUDA error 7"):
            _build.launch("mvt_fake", counter, torch.device("cuda", 0))
        assert counter.launches == 0


def offset_copy(t, offset):
    buf = torch.empty(t.numel() * t.element_size() + offset,
                      dtype=torch.uint8, device=t.device)
    return buf[offset:].view(t.dtype).view(t.shape).copy_(t)


def check_on_card(cfg, geom, batches):
    """The kernel against the plain version on the same card tensors, at
    both pitches, aligned and misaligned bases (bits 1 B off, words 4 B
    off), one launch counted each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda "
                    "tests/test_torch_bits_pitch.py)")
    need = oracle.effective_clusters_needed(cfg.clusters_needed)
    for b in batches:
        bits = torch.from_numpy(packed(masks(b, b, geom))).cuda()
        words = torch_cluster.bits_to_words(bits, geom)
        plain = torch_cluster.word_cluster_counts_plain(words, geom)
        cases = [("bits", torch_cluster.cluster_bits_op, bits, 1),
                 ("words", torch_cluster.cluster_words_op, words, 4)]
        for name, op, t, offset in cases:
            for base in (t, offset_copy(t, offset)):
                before = torch_cluster.cluster_words_op.launches
                counts, motion = op(base, geom, cfg.clusters_needed)
                torch.cuda.synchronize()
                assert torch_cluster.cluster_words_op.launches == before + 1
                assert torch.equal(counts, plain), (name, b)
                assert torch.equal(motion, plain >= need)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,vm", GEOMETRIES)
def test_cuda_kernel_at_both_pitches(dims, vm):
    """Batches 1, 7, 750 and 2048: frames bulk-copied to shared memory."""
    cfg, geom = geometry(dims, vm)
    check_on_card(cfg, geom, (1, 7, 750, 2048))


@pytest.mark.cuda
def test_cuda_kernel_frames_past_shared_memory():
    """8K at BLOCK_SHIFT 2, 259,200 B a frame at both pitches: more than a
    block's shared memory, so the kernel reads the frames from device
    memory."""
    cfg = Config(block_size=4, block_shift=2)
    geom = GridGeometry.build(7680, 4320, cfg)
    assert geom.gh * ((geom.gw + 7) // 8) == 259200
    check_on_card(cfg, geom, (1, 7, 70))
