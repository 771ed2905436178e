"""The decoder stand-in serves a file as the native scan does."""

from __future__ import annotations

import numpy as np
import pytest

from trimbench import scene, standin
from trimbench.reference import rule
from trimbench.scene import FileSpec

from trimbench_cases import small_cell

FPS = 25.0


class Timing:
    frames_with_mvs = 0


def decoder_for(name: str, seed: int = 5):
    cell = small_cell(name)
    camera, knobs = cell.config["camera"], cell.config["env"]
    geom = rule.Geometry.of(camera["width"], camera["height"], knobs)
    scenes = {k: scene.build(k, camera, p, geom, seed)
              for k, p in cell.config["scene"].items()}
    spec = FileSpec("/in/cam.mp4", 1000, FPS, ((100, 300, 3), (700, 760, 8)))
    return standin.Decoder(camera, scenes, [spec]), spec, geom


def bits_args(geom):
    return dict(threshold_sq=16.0, block_shift=4, gw=geom.gw, gh=geom.gh,
                y_min=geom.y_min, y_max=geom.y_max, vectors_needed=2)


def test_probe_reports_the_file():
    decoder, spec, _ = decoder_for("mv1080_nvr")
    with decoder(spec.name) as r:
        assert (r.duration, r.fps, r.width, r.height) == (40.0, FPS, 320, 192)
    with pytest.raises(OSError):
        decoder("/in/other.mp4")


def test_scan_serves_start_to_end():
    decoder, spec, geom = decoder_for("mv1080_nvr")
    r = decoder(spec.name)
    data, pts = r.scan_bits(4.0, 10.0, **bits_args(geom), max_frames=4096)
    assert pts[0] == 4.0 and len(pts) == 150 and pts[-1] < 10.0
    np.testing.assert_array_equal(pts, np.arange(100, 250) / FPS)
    assert data.shape == (150, geom.gh, geom.mask_bytes)
    idx, _ = decoder.scenes["bits"].index(spec, 100, 250)
    np.testing.assert_array_equal(data, decoder.scenes["bits"].pool[idx])
    assert not np.shares_memory(data, decoder.scenes["bits"].pool)
    data, pts = r.scan_bits(39.99, 50.0, **bits_args(geom))
    assert len(pts) == 0 and data.shape[0] == 0


def test_max_frames_and_resume_continue_where_the_last_scan_stopped():
    decoder, spec, geom = decoder_for("mv1080_nvr")
    whole = decoder(spec.name).scan_bits(0.0, 30.0, **bits_args(geom))
    r = decoder(spec.name)
    parts, resume = [], False
    while True:
        data, pts = r.scan_bits(0.0, 30.0, **bits_args(geom), max_frames=64,
                                resume=resume)
        if len(pts) == 0:
            break
        assert len(pts) <= 64
        parts.append((data, pts))
        resume = True
    np.testing.assert_array_equal(np.concatenate([p for _, p in parts]),
                                  whole[1])
    np.testing.assert_array_equal(np.concatenate([d for d, _ in parts]),
                                  whole[0])


def test_frames_with_mvs_counts_frames_with_side_data():
    decoder, spec, geom = decoder_for("mv1080_nvr")
    timing = Timing()
    decoder(spec.name).scan_bits(0.0, 40.0, **bits_args(geom), timing=timing)
    gop = decoder.camera["gop"]
    assert timing.frames_with_mvs == 1000 - len(range(0, 1000, gop))
    intra, ispec, igeom = decoder_for("sad1080_nvr")
    timing = Timing()
    data, _ = intra(ispec.name).scan_bits(0.0, 40.0, **bits_args(igeom),
                                          timing=timing)
    assert timing.frames_with_mvs == 0 and not data.any()


def test_scan_refuses_another_grid():
    decoder, spec, geom = decoder_for("mv1080_nvr")
    args = dict(bits_args(geom), gw=geom.gw + 1)
    with pytest.raises(RuntimeError):
        decoder(spec.name).scan_bits(0.0, 1.0, **args)


def test_luma_sub_scans_carry_into_the_next():
    """Luma served in capped sub-scans is the same frame sequence as one
    scan, so the carry (the last frame of a sub-scan) is the real
    predecessor of the next sub-scan's first frame."""
    decoder, spec, _ = decoder_for("sad1080_nvr")
    whole, wpts = decoder(spec.name).scan_luma(0.0, 30.0, max_frames=4096)
    r = decoder(spec.name)
    got, carry_ok, resume, carry = [], True, False, None
    while True:
        luma, pts = r.scan_luma(0.0, 30.0, max_frames=37, resume=resume)
        if len(pts) == 0:
            break
        if carry is not None:
            k = int(round(pts[0] * FPS))
            carry_ok &= np.array_equal(carry, whole[k - 1])
        carry = luma[-1].copy()
        got.append(luma)
        resume = True
    assert carry_ok
    np.testing.assert_array_equal(np.concatenate(got), whole)
    assert len(wpts) == 750


def test_motion_windows_change_the_frames():
    decoder, spec, _ = decoder_for("sad1080_nvr")
    luma, _ = decoder(spec.name).scan_luma(0.0, 20.0, max_frames=4096)
    planes = decoder.scenes["luma"].planes
    assert np.array_equal(luma[50], luma[50 + planes])       # static
    assert not np.array_equal(luma[150], luma[150 + planes])  # moving
