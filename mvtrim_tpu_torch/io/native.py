"""ctypes bridge to the native host media library (native/mvtrim_host.cpp).

The native library owns everything FFmpeg: mmap'd ingest, MV-export decode,
dense vote-grid scatter, raw MV / luma export, the lossless segment-concat
cut, and the synthetic clip generator.  ctypes releases the GIL during
calls, so N Python threads driving N handles decode genuinely in parallel
(the reference's per-thread MotionScanner model, motion_scanner.hpp:8-13).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

MVT_MODE_MV = 0
MVT_MODE_LUMA = 1
MVT_MODE_MV_FULL = 2  # export MVs with default decode (every frame incl. B)

_lib = None
_lib_lock = threading.Lock()

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")

# Must match mvt_abi_version() in native/mvtrim_host.cpp.  Calling a stale
# prebuilt .so with shifted ctypes signatures corrupts the stack silently,
# so the loader rebuilds (dev checkouts) or refuses on mismatch.
# v9: MV-less frames emit all-zero masks even at VECTORS_NEEDED<=0
# (reference `!sd -> false` exactness) — a semantic, not signature, bump.
# v10: adds mvt_libav_versions (doctor tool reports the linked FFmpeg).
# v11: mvt_scan_grids_multi grows a per-frame has_mv out-param so
# vec_needed<=0 sweeps can apply the reference's `!sd -> false` rule.
_ABI_VERSION = 11


def _rebuild() -> None:
    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                   capture_output=True)


def _lib_abi(lib) -> int:
    try:
        lib.mvt_abi_version.restype = ctypes.c_int
        return int(lib.mvt_abi_version())
    except AttributeError:
        return 0  # pre-versioning build


def _load_library():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        so_path = os.environ.get(
            "MVT_NATIVE_LIB", os.path.join(_NATIVE_DIR, "libmvtrim_host.so"))
        src_path = os.path.join(_NATIVE_DIR, "mvtrim_host.cpp")
        stale = (os.path.exists(so_path) and os.path.exists(src_path)
                 and os.path.getmtime(src_path) > os.path.getmtime(so_path))
        if not os.path.exists(so_path) or stale:
            # Best-effort self-build (dev checkouts); fails loudly otherwise.
            try:
                _rebuild()
            except Exception as e:
                if not os.path.exists(so_path):
                    raise OSError(f"native library missing at {so_path} "
                                  f"and build failed: {e}")
                # stale library + failed rebuild: loading anyway (the ABI
                # gate below catches version drift), but same-ABI source
                # changes would silently not take effect — say so
                import warnings

                warnings.warn(
                    f"{so_path} is older than mvtrim_host.cpp and the "
                    f"rebuild failed ({e}); loading the STALE library — "
                    "source changes are not in effect",
                    RuntimeWarning, stacklevel=2)
        lib = ctypes.CDLL(so_path)
        if _lib_abi(lib) != _ABI_VERSION:
            # stale prebuilt library: one rebuild attempt, then hard error
            try:
                _rebuild()
                lib = ctypes.CDLL(so_path)
            except Exception:
                pass
            if _lib_abi(lib) != _ABI_VERSION:
                raise OSError(
                    f"{so_path} has ABI {_lib_abi(lib)}, expected "
                    f"{_ABI_VERSION}; rebuild with `make -C native`")

        lib.mvt_open.restype = ctypes.c_void_p
        lib.mvt_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_int]
        lib.mvt_close.restype = None
        lib.mvt_close.argtypes = [ctypes.c_void_p]
        lib.mvt_probe.restype = ctypes.c_int
        lib.mvt_probe.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.mvt_scan_grids.restype = ctypes.c_long
        lib.mvt_scan_grids.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.mvt_scan_bits.restype = ctypes.c_long
        lib.mvt_scan_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.mvt_scan_words.restype = ctypes.c_long
        lib.mvt_scan_words.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.mvt_scan_grids_multi.restype = ctypes.c_long
        lib.mvt_scan_grids_multi.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int]
        lib.mvt_scan_mvs.restype = ctypes.c_long
        lib.mvt_scan_mvs.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_long, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.mvt_scan_luma.restype = ctypes.c_long
        lib.mvt_scan_luma.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.mvt_scan_mvs_full.restype = ctypes.c_long
        lib.mvt_scan_mvs_full.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_long, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.mvt_stream_counts.restype = ctypes.c_int
        lib.mvt_stream_counts.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.mvt_skip_phase.restype = ctypes.c_int
        lib.mvt_skip_phase.argtypes = [ctypes.c_void_p]
        lib.mvt_inspect_packets.restype = ctypes.c_long
        lib.mvt_inspect_packets.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_int]
        lib.mvt_stream_types.restype = ctypes.c_int
        lib.mvt_stream_types.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int]
        lib.mvt_time_base.restype = ctypes.c_int
        lib.mvt_time_base.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.mvt_cut.restype = ctypes.c_int
        lib.mvt_cut.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_char_p, ctypes.c_int]
        lib.mvt_libav_versions.restype = None
        lib.mvt_libav_versions.argtypes = [
            ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_uint),
            ctypes.POINTER(ctypes.c_uint)]
        lib.mvt_synth.restype = ctypes.c_int
        lib.mvt_synth.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return lib


class ScanTiming:
    """seek/decode/analyze microsecond accumulators (the reference's
    per-worker hot-path accounting, pipeline.cpp:180-184), plus the count
    of frames that carried MV side data (drives the SAD auto-fallback)."""

    __slots__ = ("seek_us", "decode_us", "analyze_us", "frames_with_mvs")

    def __init__(self):
        self.seek_us = 0
        self.decode_us = 0
        self.analyze_us = 0
        self.frames_with_mvs = 0

    def add_raw(self, arr):
        self.seek_us += int(arr[0])
        self.decode_us += int(arr[1])
        self.analyze_us += int(arr[2])
        if len(arr) > 3:
            self.frames_with_mvs += int(arr[3])


class VideoReader:
    """One decode handle over an mmap'd video (not thread-safe; use one
    per worker thread)."""

    def __init__(self, path: str, mode: int = MVT_MODE_MV):
        self._lib = _load_library()
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.mvt_open(path.encode(), mode, err, len(err))
        if not self._h:
            raise OSError(f"mvt_open({path}): {err.value.decode()}")
        self.path = path
        dur = ctypes.c_double()
        fps = ctypes.c_double()
        w = ctypes.c_int()
        ht = ctypes.c_int()
        self._lib.mvt_probe(self._h, ctypes.byref(dur), ctypes.byref(fps),
                            ctypes.byref(w), ctypes.byref(ht))
        self.duration = dur.value
        self.fps = fps.value
        self.width = w.value
        self.height = ht.value

    def close(self):
        if self._h:
            self._lib.mvt_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def scan_grids(self, start: float, end: float, *, threshold_sq: float,
                   block_shift: int, gw: int, gh: int, y_min: int,
                   y_max: int, frame_skip: int = 1, max_frames: int = 4096,
                   timing: ScanTiming | None = None,
                   resume: bool = False):
        """Decode [start, end) and return (grids uint8 [N, gh, gw], pts f64 [N])."""
        grids = np.empty((max_frames, gh, gw), dtype=np.uint8)
        pts = np.empty((max_frames,), dtype=np.float64)
        t = np.zeros((4,), dtype=np.int64)
        n = self._lib.mvt_scan_grids(
            self._h, start, end, threshold_sq, block_shift, gw, gh,
            y_min, y_max, frame_skip, max_frames,
            grids.ctypes.data, pts.ctypes.data, t.ctypes.data,
            int(resume))
        if n < 0:
            raise RuntimeError(f"mvt_scan_grids failed on {self.path}")
        if timing is not None:
            timing.add_raw(t)
        return grids[:n], pts[:n]

    def scan_bits(self, start: float, end: float, *, threshold_sq: float,
                  block_shift: int, gw: int, gh: int, y_min: int,
                  y_max: int, vectors_needed: int, frame_skip: int = 1,
                  max_frames: int = 4096,
                  timing: ScanTiming | None = None,
                  resume: bool = False):
        """Decode [start, end) and return bit-packed activity masks.

        Returns (bits uint8 [N, gh, ceil(gw/8)], pts f64 [N]).  Bit k of
        byte j covers grid x = j*8+k (numpy ``bitorder='little'``); a set
        bit means the cell's saturating vote count reached
        ``vectors_needed`` — the only property the cluster decision reads
        (motion_scanner.cpp:277-293).  8x smaller H2D than scan_grids.
        """
        gwb = (gw + 7) // 8
        bits = np.empty((max_frames, gh, gwb), dtype=np.uint8)
        pts = np.empty((max_frames,), dtype=np.float64)
        t = np.zeros((4,), dtype=np.int64)
        n = self._lib.mvt_scan_bits(
            self._h, start, end, threshold_sq, block_shift, gw, gh,
            y_min, y_max, vectors_needed, frame_skip, max_frames,
            bits.ctypes.data, pts.ctypes.data, t.ctypes.data,
            int(resume))
        if n < 0:
            raise RuntimeError(f"mvt_scan_bits failed on {self.path}")
        if timing is not None:
            timing.add_raw(t)
        return bits[:n], pts[:n]

    def scan_words(self, start: float, end: float, *, threshold_sq: float,
                   block_shift: int, gw: int, gh: int, y_min: int,
                   y_max: int, vectors_needed: int, frame_skip: int = 1,
                   max_frames: int = 4096,
                   timing: ScanTiming | None = None,
                   resume: bool = False):
        """Decode [start, end) and return word-layout activity masks.

        Returns (words int32 [N, gh*gww], pts f64 [N]) where gww =
        ceil(gw/32) and word w of a row holds cells x = 32w..32w+31 in
        little-endian bit order — exactly
        ``ops.cluster.repack_bits_words(scan_bits(...))`` emitted
        natively, so the device feeder only assembles batches (no
        per-frame repack on the Python side).
        """
        gww = (gw + 31) // 32
        words = np.empty((max_frames, gh * gww), dtype=np.int32)
        pts = np.empty((max_frames,), dtype=np.float64)
        t = np.zeros((4,), dtype=np.int64)
        n = self._lib.mvt_scan_words(
            self._h, start, end, threshold_sq, block_shift, gw, gh,
            y_min, y_max, vectors_needed, frame_skip, max_frames,
            words.ctypes.data, pts.ctypes.data, t.ctypes.data,
            int(resume))
        if n < 0:
            raise RuntimeError(f"mvt_scan_words failed on {self.path}")
        if timing is not None:
            timing.add_raw(t)
        return words[:n], pts[:n]

    def scan_grids_multi(self, start: float, end: float, *,
                         thresholds_sq, block_shift: int, gw: int, gh: int,
                         y_min: int, y_max: int, frame_skip: int = 1,
                         max_frames: int = 4096,
                         timing: ScanTiming | None = None,
                         resume: bool = False):
        """One decode pass, K vote grids per frame (one per threshold).

        Returns (grids uint8 [N, K, gh, gw], pts f64 [N], has_mv bool [N]).
        ``has_mv`` marks frames that carried MV side data — a zero grid
        cannot distinguish "no side data" (reference: unconditional
        ``!sd -> false``, motion_scanner.cpp:219-221) from "MVs present
        but none voted", and the distinction decides vec_needed<=0.
        """
        thr = np.ascontiguousarray(thresholds_sq, dtype=np.float64)
        k = len(thr)
        grids = np.empty((max_frames, k, gh, gw), dtype=np.uint8)
        pts = np.empty((max_frames,), dtype=np.float64)
        has_mv = np.zeros((max_frames,), dtype=np.uint8)
        t = np.zeros((4,), dtype=np.int64)
        n = self._lib.mvt_scan_grids_multi(
            self._h, start, end, thr.ctypes.data, k, block_shift, gw, gh,
            y_min, y_max, frame_skip, max_frames,
            grids.ctypes.data, pts.ctypes.data, has_mv.ctypes.data,
            t.ctypes.data, int(resume))
        if n < 0:
            raise RuntimeError(f"mvt_scan_grids_multi failed on {self.path}")
        if timing is not None:
            timing.add_raw(t)
        return grids[:n], pts[:n], has_mv[:n].astype(bool)

    def scan_mvs(self, start: float, end: float, *, frame_skip: int = 1,
                 max_frames: int = 4096, max_mv: int = 8192,
                 timing: ScanTiming | None = None,
                 resume: bool = False):
        """Decode [start, end) and return raw MVs.

        Returns (mvs int16 [N, max_mv, 4], counts int32 [N], pts f64 [N]).
        Negative count means the frame overflowed max_mv (|count| = real).
        """
        mvs = np.zeros((max_frames, max_mv, 4), dtype=np.int16)
        counts = np.zeros((max_frames,), dtype=np.int32)
        pts = np.empty((max_frames,), dtype=np.float64)
        t = np.zeros((4,), dtype=np.int64)
        n = self._lib.mvt_scan_mvs(
            self._h, start, end, frame_skip, max_frames, max_mv,
            mvs.ctypes.data, counts.ctypes.data, pts.ctypes.data,
            t.ctypes.data, int(resume))
        if n < 0:
            raise RuntimeError(f"mvt_scan_mvs failed on {self.path}")
        if timing is not None:
            timing.add_raw(t)
        return mvs[:n], counts[:n], pts[:n]

    def stream_counts(self) -> tuple[int, int]:
        """(total streams, audio streams) in the container."""
        n = ctypes.c_int()
        a = ctypes.c_int()
        rc = self._lib.mvt_stream_counts(self._h, ctypes.byref(n),
                                         ctypes.byref(a))
        if rc != 0:
            raise RuntimeError(f"mvt_stream_counts failed on {self.path}")
        return n.value, a.value

    def time_base(self) -> tuple[int, int]:
        num = ctypes.c_int()
        den = ctypes.c_int()
        self._lib.mvt_time_base(self._h, ctypes.byref(num), ctypes.byref(den))
        return num.value, den.value

    def stream_types(self) -> list[int]:
        """Per-stream codec types: 0 video, 1 audio, 2 other."""
        # size the buffer from the container's actual stream count —
        # a fixed cap would silently truncate exotic many-stream files
        # (mvt_stream_types writes at most max_streams entries)
        cap = max(1, self.stream_counts()[0])
        types = np.zeros((cap,), np.int32)
        n = self._lib.mvt_stream_types(self._h, types.ctypes.data, cap)
        if n < 0:
            raise RuntimeError(f"mvt_stream_types failed on {self.path}")
        return types[:min(n, cap)].tolist()

    def skip_phase(self) -> int:
        """Frame-skip modulo phase at the handle's current decode
        position (frames decoded since the active range's seek).  A
        ``resume=True`` scan continues from this phase — the mechanism
        that keeps cap-resumed chunks bit-identical to the reference's
        single uninterrupted counter per chunk
        (motion_scanner.cpp:314,356-357)."""
        return int(self._lib.mvt_skip_phase(self._h))

    def scan_mvs_full(self, start: float, end: float, *, frame_skip: int = 1,
                      max_frames: int = 4096, max_mv: int = 8192,
                      timing: ScanTiming | None = None,
                      resume: bool = False):
        """Full-field MV export (extract_mvs schema).

        Returns (mvs int32 [N, max_mv, 10], counts int32 [N],
        pts f64 [N] (best_effort), ptype int32 [N]).  MV fields:
        dst_x, dst_y, src_x, src_y, w, h, motion_x, motion_y,
        motion_scale, source.
        """
        mvs = np.zeros((max_frames, max_mv, 10), dtype=np.int32)
        counts = np.zeros((max_frames,), dtype=np.int32)
        pts = np.empty((max_frames,), dtype=np.float64)
        ptype = np.zeros((max_frames,), dtype=np.int32)
        t = np.zeros((4,), dtype=np.int64)
        n = self._lib.mvt_scan_mvs_full(
            self._h, start, end, frame_skip, max_frames, max_mv,
            mvs.ctypes.data, counts.ctypes.data, pts.ctypes.data,
            ptype.ctypes.data, t.ctypes.data, int(resume))
        if n < 0:
            raise RuntimeError(f"mvt_scan_mvs_full failed on {self.path}")
        if timing is not None:
            timing.add_raw(t)
        return mvs[:n], counts[:n], pts[:n], ptype[:n]

    def scan_luma(self, start: float, end: float, *, frame_skip: int = 1,
                  max_frames: int = 256, timing: ScanTiming | None = None,
                  resume: bool = False):
        """Decode [start, end) and return (luma uint8 [N, H, W], pts f64 [N])."""
        luma = np.empty((max_frames, self.height, self.width), dtype=np.uint8)
        pts = np.empty((max_frames,), dtype=np.float64)
        t = np.zeros((4,), dtype=np.int64)
        n = self._lib.mvt_scan_luma(
            self._h, start, end, frame_skip, max_frames,
            luma.ctypes.data, pts.ctypes.data, t.ctypes.data,
            int(resume))
        if n < 0:
            raise RuntimeError(f"mvt_scan_luma failed on {self.path}")
        if timing is not None:
            timing.add_raw(t)
        return luma[:n], pts[:n]


def inspect_packets(path: str, max_packets: int = 1 << 20):
    """Demux-only packet inspection (test oracle for cut invariants).

    Returns (stream int32 [N], dts f64 [N], pts f64 [N], key int32 [N])
    in file order; dts/pts are seconds (NaN when the packet has none).
    """
    lib = _load_library()
    stream = np.empty((max_packets,), np.int32)
    dts = np.empty((max_packets,), np.float64)
    pts = np.empty((max_packets,), np.float64)
    key = np.empty((max_packets,), np.int32)
    err = ctypes.create_string_buffer(256)
    n = lib.mvt_inspect_packets(path.encode(), stream.ctypes.data,
                                dts.ctypes.data, pts.ctypes.data,
                                key.ctypes.data, max_packets, err, len(err))
    if n < 0:
        raise RuntimeError(f"mvt_inspect_packets({path}): "
                           f"{err.value.decode()}")
    if n >= max_packets:
        # the native walk stops at max_packets, so n == max means the
        # tail went unseen — an invariant oracle must not silently pass
        # on a prefix (a file with exactly max packets pays a re-run)
        raise RuntimeError(
            f"mvt_inspect_packets({path}): output truncated at "
            f"max_packets={max_packets}; raise the limit")
    return stream[:n], dts[:n], pts[:n], key[:n]


def cut(input_path: str, output_path: str, segments) -> None:
    """Lossless segment concat (native remux; no external ffmpeg needed).

    ``segments`` is a sequence of (start, end) seconds; callers should pass
    %.2f-quantized values to match the reference's concat-list contract.
    """
    lib = _load_library()
    flat = np.asarray([v for s in segments for v in (s[0], s[1])],
                      dtype=np.float64)
    err = ctypes.create_string_buffer(256)
    rc = lib.mvt_cut(input_path.encode(), output_path.encode(),
                     flat.ctypes.data, len(flat) // 2, err, len(err))
    if rc != 0:
        raise RuntimeError(
            f"mvt_cut({input_path} -> {output_path}): {err.value.decode()}")


def synthesize(path: str, *, width: int = 640, height: int = 480,
               fps: float = 25.0, duration: float = 10.0,
               codec: str = "libx264", motion_windows=((2.0, 5.0),),
               gop: int = 0, b_frames: int = 0, noise: int = 0,
               with_audio: bool = False) -> None:
    """Generate a synthetic moving-box clip (tests/benches).

    b_frames > 0 enables B-frames (exercises decode-order handling);
    noise > 0 adds +-noise per-pixel sensor noise per frame (realistic
    CCTV: stresses thresholds and encoder MV counts); with_audio adds a
    mono AAC sine track (exercises the cut's non-video windowing).
    """
    lib = _load_library()
    flat = np.asarray([v for w in motion_windows for v in (w[0], w[1])],
                      dtype=np.float64)
    err = ctypes.create_string_buffer(256)
    rc = lib.mvt_synth(path.encode(), width, height, fps, duration,
                       codec.encode(), flat.ctypes.data, len(flat) // 2,
                       gop, b_frames, noise, int(with_audio), err,
                       len(err))
    if rc != 0:
        raise RuntimeError(f"mvt_synth({path}): {err.value.decode()}")


class ChunkScanCursor:
    """Cap-resume chunk protocol for sequential whole-video scans.

    The reference runs one ``scan_range`` per CHUNK_DURATION_SEC chunk
    with the frame-skip counter local to that call
    (motion_scanner.cpp:314,356-357); our native scans bound each call
    with ``max_frames``, so a VFR burst can saturate the cap mid-chunk.
    The protocol that keeps the analyzed frame set identical to the
    reference's is: re-call the scan with ``resume=True`` (continues the
    decode from the exact stream position with the skip counter carried)
    and only advance the time cursor once a scan comes back under the
    cap.  This cursor owns that state for the sequential scan loops
    (tools/tune.py both routes, tools/heatmap.py); the pipeline/archive
    workers keep their own task-window drains, which interleave the same
    protocol with restart/dedup/carry machinery of their own.

        cur = ChunkScanCursor(duration, chunk_sec, cap)
        while cur.more():
            start, end = cur.window()
            ..., pts = reader.scan_*(start, end, ..., max_frames=cap,
                                     resume=cur.resume)
            cur.advance(len(pts))
    """

    def __init__(self, duration: float, chunk_sec: float, cap: int):
        self.duration = duration
        self.chunk = chunk_sec
        self.cap = cap
        self.t = 0.0
        self.resume = False

    def more(self) -> bool:
        return self.t < self.duration

    def window(self) -> tuple[float, float]:
        return self.t, min(self.t + self.chunk, self.duration)

    def advance(self, n_pts: int) -> None:
        """Record a scan's frame count: saturated caps resume the same
        chunk; anything under the cap moves to the next chunk."""
        self.resume = n_pts == self.cap
        if not self.resume:
            self.t = self.window()[1]

    def restart_chunk(self) -> None:
        """Rescan the current chunk from a fresh seek (e.g. after an
        MV-capacity overflow invalidates its partial results); the skip
        phase restarts with it, matching the reference's per-chunk
        counter."""
        self.resume = False


def libav_versions() -> dict[str, str]:
    """Runtime versions of the linked libav* libraries ("major.minor.micro").

    avcodec major >= 61 (FFmpeg >= 7) is required for HEVC motion-vector
    export — the capability the reference's Dockerfile builds FFmpeg 8
    from source for (reference Dockerfile:46-65).
    """
    lib = _load_library()
    vals = [ctypes.c_uint(0) for _ in range(3)]
    lib.mvt_libav_versions(*(ctypes.byref(v) for v in vals))
    def fmt(v: int) -> str:
        return f"{v >> 16}.{(v >> 8) & 0xFF}.{v & 0xFF}"
    return {"avformat": fmt(vals[0].value),
            "avcodec": fmt(vals[1].value),
            "avutil": fmt(vals[2].value)}


_hevc_mv_capable: bool | None = None


def hevc_mv_export_capable() -> bool:
    """Does the linked libavcodec export HEVC motion-vector side data?

    FFmpeg < 7 exports AV_FRAME_DATA_MOTION_VECTORS only for the
    mpegvideo/h264 decoder families; the reference deploys FFmpeg 8 built
    from source (reference Dockerfile:46-65) and scans HEVC MVs natively.
    This probe encodes a 1s HEVC clip and checks whether any decoded
    frame carries MV side data — callers gate the HEVC MV path (vs the
    SAD fallback) and the HEVC parity tests on it.  Cached per process;
    returns False when no HEVC encoder is linked (probe impossible).
    """
    global _hevc_mv_capable
    if _hevc_mv_capable is not None:
        return _hevc_mv_capable
    import tempfile

    try:
        with tempfile.TemporaryDirectory() as td:
            clip = os.path.join(td, "probe.mp4")
            synthesize(clip, width=160, height=128, fps=25.0, duration=1.0,
                       codec="libx265", motion_windows=((0.0, 1.0),))
            with VideoReader(clip) as r:
                tm = ScanTiming()
                r.scan_grids(0.0, 2.0, threshold_sq=0.0, block_shift=4,
                             gw=10, gh=8, y_min=0, y_max=8,
                             max_frames=30, timing=tm)
            _hevc_mv_capable = tm.frames_with_mvs > 0
    except (RuntimeError, OSError):
        _hevc_mv_capable = False
    return _hevc_mv_capable
