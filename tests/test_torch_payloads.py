"""Each scan payload through ``ProcessingPipeline``, pinned.

One file a case on the plain build (``scan_backend="torch"``), one decode
worker, 4-s chunks and 16-frame device batches: bits, words and grids
over replay fixture A (also bits at 20 frames a scan call), mv_raw over
fixture B (also at two frames a call, where a chunk decoded in sub-calls
restarts) and luma over fixture D (the SAD scan, also at 16 frames a
call, where each sub-scan carries its predecessor's last frame).  Each
case's reader opens and calls (every keyword but the timing), the
program's spans as sorted (name, value) pairs, the metrics line's
``phases_us`` keys and counts, the ``ScanResult``, the heatmap (its
activity as a digest), and the
batches that a class-level patch of the detector's method sees are held
to ``torch_payloads_expected.json``.

``PYTHONPATH=. python tests/test_torch_payloads.py`` writes that file anew.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

import pytest

from mvtrim_tpu_torch.bench import replay
from mvtrim_tpu_torch.io import native
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.models.sad_detector import SADDetector
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline
from mvtrim_tpu_torch.utils import timing
from mvtrim_tpu_torch.utils.timing import TimingCollector

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_payloads_expected.json")
# case -> (fixture, Config fields, the detector method each batch takes)
CASES = {
    "bits": ("A", {}, "scan_bits_async"),
    "bits_cap20": ("A", {"chunk_frames_cap": 20}, "scan_bits_async"),
    "words": ("A", {"scan_input": "words"}, "scan_words_async"),
    "grids": ("A", {"scan_input": "grids"}, "scan_votes_async"),
    "mv_raw": ("B", {"scan_input": "mv_raw"}, "scan_raw_mvs_async"),
    "mv_raw_cap2": ("B", {"scan_input": "mv_raw", "chunk_frames_cap": 2},
                    "scan_raw_mvs_async"),
    "luma": ("D", {"pipeline_mode": "sad"}, "scan_luma"),
    "luma_cap16": ("D", {"pipeline_mode": "sad", "chunk_frames_cap": 16},
                   "scan_luma"),
}


def observe(case: str, tmp: str) -> dict:
    """One case's run, as the JSON the expected file holds."""
    name, fields, method = CASES[case]
    fx = replay.load(name)
    owner = SADDetector if method == "scan_luma" else MVClusterDetector
    calls, seen, scans = [], [], []

    class Traced(replay.ReplayReader):
        def _call(self, method, start, end, kw):
            calls.append([method, float(start), float(end),
                          {k: v for k, v in kw.items() if k != "timing"}])
            return getattr(super(), method)(start, end, **kw)

        def scan_bits(self, start, end, **kw):
            return self._call("scan_bits", start, end, kw)

        def scan_words(self, start, end, **kw):
            return self._call("scan_words", start, end, kw)

        def scan_grids(self, start, end, **kw):
            return self._call("scan_grids", start, end, kw)

        def scan_mvs(self, start, end, **kw):
            return self._call("scan_mvs", start, end, kw)

        def scan_luma(self, start, end, **kw):
            return self._call("scan_luma", start, end, kw)

    def open_reader(path, mode=native.MVT_MODE_MV):
        calls.append(["open", int(mode)])
        return Traced(fx, mode, path)

    real_method = getattr(owner, method)

    def patched(self, data, *rest, **kw):
        seen.append(int(data.shape[0]))
        return real_method(self, data, *rest, **kw)

    heat_dir = os.path.join(tmp, "heat")
    os.makedirs(heat_dir, exist_ok=True)
    metrics = os.path.join(tmp, "metrics.jsonl")
    src = os.path.join(tmp, f"{case}.mp4")
    cfg = fx.config(scan_backend="torch", decode_workers=1,
                    chunk_duration_sec=4.0, device_batch=16,
                    heatmap_path="" if name == "D" else heat_dir,
                    metrics_json=metrics, ffmpeg_bin=replay.FAKE_FFMPEG,
                    **fields)
    real_reader = native.VideoReader
    native.VideoReader = open_reader
    setattr(owner, method, patched)
    try:
        pipe = ProcessingPipeline(src, src + ".out", cfg=cfg)
        scan = pipe._parallel_scan
        pipe._parallel_scan = lambda *a: scans.append(scan(*a)) or scans[-1]
        timing.start_recording()
        try:
            rc = pipe.run()
        finally:
            spans = timing.stop_recording()
            TimingCollector.clear()
    finally:
        setattr(owner, method, real_method)
        native.VideoReader = real_reader
    with open(metrics) as f:
        (line,) = [json.loads(x) for x in f]
    heatmap = None
    heat_file = os.path.join(heat_dir, os.path.basename(src)
                             + ".heatmap.json")
    if os.path.exists(heat_file):
        with open(heat_file) as f:
            heatmap = json.load(f)
        heatmap.pop("input")
        heatmap["activity"] = hashlib.sha256(
            json.dumps(heatmap["activity"]).encode()).hexdigest()
    return {
        "rc": rc,
        "calls": calls,
        "spans": sorted([s.name, s.value] for s in spans),
        "phases": list(line["phases_us"]),
        "metrics": {k: line[k] for k in (
            "frames_scanned", "frames_with_mvs", "motion_frames",
            "decision", "saved_pct")},
        "scans": [[r.motion_ts, r.frames_scanned, r.frames_with_mvs,
                   r.chunks] for r in scans],
        "heatmap": heatmap,
        "seen": seen,
    }


@pytest.fixture(scope="module")
def expected():
    with open(EXPECTED) as f:
        return json.load(f)


@pytest.mark.parametrize("case", CASES)
def test_a_payload_scans_as_pinned(case, expected, tmp_path):
    got = json.loads(json.dumps(observe(case, str(tmp_path))))
    want = expected[case]
    assert got["rc"] == want["rc"] == 0
    assert got["calls"] == want["calls"]
    assert got["spans"] == want["spans"]
    assert got["phases"] == want["phases"]
    assert got["metrics"] == want["metrics"]
    assert got["scans"] == want["scans"]
    assert got["heatmap"] == want["heatmap"]
    assert got["seen"] == want["seen"]
    # the class-level patch saw the warm-up and then every scanned frame
    (scan,) = got["scans"]
    assert sum(got["seen"][1:]) == scan[1] > 0


if __name__ == "__main__":
    out = {}
    for case in CASES:
        with tempfile.TemporaryDirectory() as tmp:
            out[case] = observe(case, tmp)
        TimingCollector.clear()
        print(case, len(out[case]["calls"]), len(out[case]["spans"]),
              file=sys.stderr)
    with open(EXPECTED, "w") as f:
        json.dump(out, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
