"""doctor — one-command environment & capability report.

The counterpart of ``mvtrim_tpu/tools/doctor.py``.  Every capability the
port needs is made explicit BEFORE a production run:

* native media library loads, ABI matches, linked libav* versions;
* H.264 motion-vector export (the core scan input) actually works;
* HEVC motion-vector export (FFmpeg >= 7) — WARN, not FAIL, when absent
  because the single-file pipeline auto-falls back to the pixel-domain
  SAD detector;
* stream-copy remux cut produces a decodable output;
* the CUDA inventory, ``nvcc``, the build and load of the port's kernel
  library (``ops/_build.py``), whether that library was prebuilt in its
  directory (MVT_COMPILE_CACHE; an image has it there and no ``nvcc``, so
  a missing ``nvcc`` is then a WARN), and the device mesh;
* a full end-to-end trim on a synthesized clip, on the scan backend of
  MVT_SCAN_BACKEND: the card by default (``auto``), the CPU build with
  ``torch``, the NumPy oracle with ``oracle``.

A probe that raises is a failed check, never a crash: on a host without
FFmpeg's libraries the media checks fail and the CUDA checks still run.
Exit code = number of FAILed checks (0 when everything required works).
``--json`` prints machine-readable records instead of the table.

Usage: python -m mvtrim_tpu_torch.tools.doctor [--json]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile


def _check_native() -> dict:
    import ctypes

    from ..io import native
    lib = native._load_library()
    lib.mvt_version.restype = ctypes.c_char_p
    ver = lib.mvt_version().decode()
    return {"name": "native-library", "status": "ok",
            "detail": f"{ver}, ABI {native._ABI_VERSION}"}


def _check_libav() -> dict:
    from ..io import native
    vers = native.libav_versions()
    avcodec_major = int(vers["avcodec"].split(".")[0])
    detail = ", ".join(f"{k} {v}" for k, v in vers.items())
    if avcodec_major >= 61:  # FFmpeg >= 7
        return {"name": "libav", "status": "ok",
                "detail": detail + " (HEVC MV export supported)"}
    return {"name": "libav", "status": "warn",
            "detail": detail + " — FFmpeg < 7: no HEVC MV export; HEVC "
            "inputs use the SAD fallback (single-file mode only)"}


def _check_h264_mv() -> dict:
    from ..io import native
    with tempfile.TemporaryDirectory() as td:
        clip = os.path.join(td, "probe.mp4")
        native.synthesize(clip, width=160, height=128, fps=25.0,
                          duration=1.0, codec="libx264",
                          motion_windows=((0.0, 1.0),))
        with native.VideoReader(clip) as r:
            tm = native.ScanTiming()
            r.scan_grids(0.0, 2.0, threshold_sq=0.0, block_shift=4,
                         gw=10, gh=8, y_min=0, y_max=8, max_frames=30,
                         timing=tm)
    if tm.frames_with_mvs > 0:
        return {"name": "h264-mv-export", "status": "ok",
                "detail": f"{tm.frames_with_mvs} MV frames from a 1s probe"}
    return {"name": "h264-mv-export", "status": "fail",
            "detail": "decoded H.264 frames carry no MV side data — the "
            "MV scan path is broken on this libavcodec"}


def _check_hevc_mv() -> dict:
    from ..io import native
    if native.hevc_mv_export_capable():
        return {"name": "hevc-mv-export", "status": "ok",
                "detail": "HEVC frames carry MV side data"}
    return {"name": "hevc-mv-export", "status": "warn",
            "detail": "no HEVC MV side data (needs FFmpeg >= 7; see the "
            "Dockerfile) — HEVC inputs fall back to the SAD detector"}


def _check_cut() -> dict:
    from ..io import native
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "src.mp4")
        dst = os.path.join(td, "dst.mp4")
        native.synthesize(src, width=160, height=128, fps=25.0,
                          duration=4.0, codec="libx264",
                          motion_windows=((0.0, 4.0),))
        native.cut(src, dst, [(0.5, 2.5)])
        with native.VideoReader(dst) as r:
            dur = r.duration
    # a 2s segment may stretch to ~3s from keyframe anchoring, but a cut
    # that ignored the segment list and copied the whole 4s stream (the
    # most plausible cut regression) must FAIL, so the bound sits below 4
    if 0.5 <= dur <= 3.5:
        return {"name": "remux-cut", "status": "ok",
                "detail": f"2s segment remuxed, output decodes ({dur:.2f}s)"}
    return {"name": "remux-cut", "status": "fail",
            "detail": f"cut output duration {dur:.2f}s outside [0.5, 3.5] "
                      f"(expected ~2s for a 2s segment of a 4s source)"}


def _check_cuda() -> dict:
    import torch

    from .device_probe import cuda_devices
    devs = cuda_devices()
    if not devs:
        return {"name": "cuda-devices", "status": "fail",
                "detail": f"torch {torch.__version__}: no CUDA device — the "
                "kernels cannot run (MVT_SCAN_BACKEND=torch runs the CPU "
                "build)"}
    cards = ", ".join(f"{d['name']} (capability {d['capability']}, "
                      f"{d['sm_count']} SMs)" for d in devs)
    return {"name": "cuda-devices", "status": "ok",
            "detail": f"torch {torch.__version__}, CUDA "
                      f"{torch.version.cuda}: {cards}"}


def _check_nvcc() -> dict:
    from ..ops import _build
    try:
        nvcc = _build._nvcc()
    except RuntimeError as e:
        if not os.path.exists(_build.library_path()):
            raise
        return {"name": "nvcc", "status": "warn",
                "detail": f"{e}; the library for these sources is "
                          f"prebuilt, so nothing needs it"}
    out = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return {"name": "nvcc", "status": "ok",
            "detail": f"{nvcc}: {out.splitlines()[-1]}"}


def _check_kernels() -> dict:
    from ..ops import _build
    _build.load_library()
    built = (f"built in {_build.build_info['seconds']:.1f}s"
             if _build.build_info else "already built")
    return {"name": "kernel-library", "status": "ok",
            "detail": f"{len(_build.sources())} CUDA sources for "
                      f"{' '.join(_build.ARCH_FLAGS[1:])}, {built}: "
                      f"{_build.library_path()}"}


def _check_kernel_cache() -> dict:
    from ..ops import _build
    path = _build.library_path()
    where = f"{os.path.basename(path)} in {_build.build_dir()}"
    if _build.build_info.get("path") == path:
        return {"name": "kernel-cache", "status": "warn",
                "detail": f"{where}: not prebuilt, this process built it "
                          f"(first use of every fresh directory does)"}
    if os.path.exists(path):
        return {"name": "kernel-cache", "status": "ok",
                "detail": f"{where}: prebuilt, loads without nvcc"}
    try:
        _build._nvcc()
    except RuntimeError as e:
        return {"name": "kernel-cache", "status": "fail",
                "detail": f"no {where}, and {e}"}
    return {"name": "kernel-cache", "status": "warn",
            "detail": f"no {where}: first use builds it with nvcc"}


def _check_mesh() -> dict:
    from ..parallel.mesh import build_mesh
    mesh = build_mesh()
    return {"name": "device-mesh", "status": "ok",
            "detail": f"mesh {mesh.shape} over "
                      f"{[str(d) for d in mesh.devices.ravel()]}"}


def _check_e2e(backend: str) -> dict:
    import contextlib
    import io

    from ..core.config import Config
    from ..io import native
    from ..pipeline.pipeline import ProcessingPipeline
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "e2e.mp4")
        dst = os.path.join(td, "out.mp4")
        native.synthesize(src, width=320, height=240, fps=25.0,
                          duration=8.0, codec="libx264",
                          motion_windows=((1.0, 3.0),))
        cfg = Config(scan_backend=backend, min_savings_pct=5.0)
        # the doctor's report is the output; swallow the run's own logs
        with contextlib.redirect_stdout(io.StringIO()):
            rc = ProcessingPipeline(src, dst, stream_id=-1, num_threads=2,
                                    cfg=cfg).run()
        if rc != 0:
            return {"name": f"end-to-end ({backend})", "status": "fail",
                    "detail": f"pipeline exit code {rc}"}
        if not os.path.exists(dst):
            return {"name": f"end-to-end ({backend})", "status": "fail",
                    "detail": "no output produced for a clip with motion"}
        with native.VideoReader(dst) as r:
            dur = r.duration
    return {"name": f"end-to-end ({backend})", "status": "ok",
            "detail": f"8s clip with a 2s motion window trimmed to "
                      f"{dur:.1f}s"}


def run_checks() -> list[dict]:
    from ..core.config import Config
    backend = Config.from_env().scan_backend
    # explicit names so a CRASHED probe reports under the same key its
    # success path would (--json consumers key checks by name)
    checks = [
        ("native-library", _check_native),
        ("libav", _check_libav),
        ("h264-mv-export", _check_h264_mv),
        ("hevc-mv-export", _check_hevc_mv),
        ("remux-cut", _check_cut),
        ("cuda-devices", _check_cuda),
        ("nvcc", _check_nvcc),
        ("kernel-library", _check_kernels),
        ("kernel-cache", _check_kernel_cache),
        ("device-mesh", _check_mesh),
        (f"end-to-end ({backend})", lambda: _check_e2e(backend)),
    ]
    out = []
    for name, fn in checks:
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 — a probe crash IS the finding
            first = str(e).partition("\n")[0]
            out.append({"name": name, "status": "fail",
                        "detail": f"{type(e).__name__}: {first}"})
    return out


def report(results: list[dict]) -> str:
    """The human-readable table of ``run_checks``' results."""
    tag = {"ok": "[ OK ]", "warn": "[WARN]", "fail": "[FAIL]"}
    lines = [f"{tag[r['status']]} {r['name']:<22} {r['detail']}"
             for r in results]
    fails = sum(r["status"] == "fail" for r in results)
    warns = sum(r["status"] == "warn" for r in results)
    lines.append(f"\n{len(results)} checks: {len(results) - fails - warns} "
                 f"ok, {warns} warnings, {fails} failures")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    results = run_checks()
    fails = sum(r["status"] == "fail" for r in results)
    if "--json" in argv:
        print(json.dumps({"checks": results, "failures": fails}, indent=2))
    else:
        print(report(results))
    return fails


if __name__ == "__main__":
    sys.exit(main())
