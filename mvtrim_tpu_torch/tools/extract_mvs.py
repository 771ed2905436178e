"""extract_mvs — dump per-frame motion-vector side data to JSON.

Same schema as the reference tool (tools/extract_mvs.cpp:97-169): top-level
``input`` / ``time_base`` / ``frames``; per frame ``frame_index`` (1-based
over every decoded frame in decode order, B-frames included),
``pts_seconds`` (best-effort timestamp, null if unknown), ``frame_type``
(I/P/B/?), ``num_mvs`` and the ``motion_vectors`` list with integer dst and
*sub-pel* src derived from motion_x/motion_scale (extract_mvs.cpp:148-151).

The export runs as a single native pass (native mvt_export_mvs_json):
no pts windowing, so B-frames whose decode order crosses time boundaries
cannot be dropped, and memory stays O(1) regardless of video length.

Usage: python -m mvtrim_tpu_torch.tools.extract_mvs input.mp4 output.json
"""

from __future__ import annotations

import ctypes
import json
import sys

from ..io import native


def export(input_path: str, output_path: str) -> int:
    """Write the extract_mvs JSON for a video; returns the frame count."""
    lib = native._load_library()
    if not hasattr(lib, "_export_sig_set"):
        lib.mvt_export_mvs_json.restype = ctypes.c_long
        lib.mvt_export_mvs_json.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib._export_sig_set = True
    err = ctypes.create_string_buffer(256)
    n = lib.mvt_export_mvs_json(input_path.encode(), output_path.encode(),
                                err, len(err))
    if n < 0:
        raise RuntimeError(
            f"extract_mvs({input_path}): {err.value.decode()}")
    return int(n)


def extract(input_path: str) -> dict:
    """Return the extract_mvs document for a video (via the native export)."""
    import tempfile
    import os

    with tempfile.NamedTemporaryFile("r", suffix=".json",
                                     delete=False) as f:
        tmp = f.name
    try:
        export(input_path, tmp)
        with open(tmp) as f:
            return json.load(f)
    finally:
        os.unlink(tmp)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print("Usage: extract_mvs input.mp4 output.json", file=sys.stderr)
        return 1
    export(argv[0], argv[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
