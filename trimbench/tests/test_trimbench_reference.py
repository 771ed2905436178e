"""The plain reference against brute force, against the generator's known
motion windows, and against the program's CPU build."""

from __future__ import annotations

import numpy as np
import pytest

from trimbench import backlog, check, control
from trimbench.reference import frames, rule, segments

from trimbench_cases import run_small, small_cell

KNOBS = {"BLOCK_SIZE": 16, "VERTICAL_MASK": 0.05, "CLUSTERS_NEEDED": 2,
         "MVT_SAD_THRESHOLD": 12, "MAX_GAP_SEC": 5, "PADDING_SEC": 0.5,
         "MIN_SAVINGS_PCT": 5}


def brute_clusters(active, geom):
    gh, gw = active.shape
    on = lambda y, x: 0 <= y < gh and 0 <= x < gw and active[y, x]
    return sum(1 for y in range(geom.y_min, geom.y_max)
               for x in range(1, gw - 1)
               if active[y, x] and (on(y, x - 1) or on(y, x + 1)
                                    or on(y - 1, x) or on(y + 1, x)))


@pytest.mark.parametrize("width,height", [(320, 192), (200, 90), (33, 17)])
def test_cluster_counts_match_brute_force(width, height):
    geom = rule.Geometry.of(width, height, KNOBS)
    rng = np.random.default_rng(width)
    active = rng.random((6, geom.gh, geom.gw)) < 0.3
    got = rule.cluster_counts(active, geom)
    assert got.tolist() == [brute_clusters(a, geom) for a in active]
    packed = rule.pack_masks(active)
    assert np.array_equal(rule.unpack_masks(packed, geom), active)


def test_block_sad_matches_brute_force():
    geom = rule.Geometry.of(40, 24, KNOBS)
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 256, (2, 24, 40), dtype=np.uint8)
    got = rule.block_sad(a, b, geom)
    d = np.abs(a.astype(int) - b.astype(int))
    want = [[d[y:y + 16, x:x + 16].sum() for x in range(0, 40, 16)]
            for y in range(0, 24, 16)]
    assert got.tolist() == want


def test_segments_pad_split_and_decide():
    ts = np.array([1.0, 1.04, 3.0, 20.0, 20.5])
    segs = segments.segments(segments.merge(ts), 21.0, KNOBS)
    assert segs == [(0.5, 3.5), (19.5, 21.0)]
    assert segments.decide(segs, 21.0, KNOBS)[0] == "cut"
    assert segments.decide([(0.0, 20.5)], 21.0, KNOBS) == (
        "copy", [(0.0, 21.0)])
    text = segments.concat_list("/a.mp4", segs)
    assert text.splitlines()[:3] == ["file '/a.mp4'", "inpoint 0.50",
                                     "outpoint 3.50"]
    assert segments.cut_of([], 10.0, "/a.mp4", KNOBS) == ("no_motion", None)


def test_chunk_firsts_follow_the_chunks():
    firsts = frames.chunk_firsts(2000, 25.0, 30.0)
    assert np.nonzero(firsts)[0].tolist() == [0, 750, 1500]


@pytest.mark.parametrize("name", ["mv1080_nvr", "sad1080_events"])
def test_reference_follows_the_generators_windows(name):
    cell = small_cell(name, files=24)
    specs, ref = control.build(cell, 11, "/in")
    kinds = {"none": 0, "copy": 0, "motion": 0}
    for s in specs:
        want = ref.expected(s)
        ts = want.passes[-1][3]
        idx = np.round(ts * s.fps).astype(int)
        inside = np.zeros(s.frames + 1, bool)
        for a, b, _ in s.windows:
            # a pixel scan also sees the object leave, in the frame after
            inside[a:b + (name.startswith("sad"))] = True
        assert inside[idx].all(), "motion outside every window"
        if not s.windows:
            kinds["none"] += 1
            assert want.decision == "no_motion" and want.concat is None
        elif s.windows == ((0, s.frames, s.windows[0][2]),):
            kinds["copy"] += 1
            assert want.decision == "copy"
        else:
            kinds["motion"] += 1
            assert len(ts) > 0.5 * s.motion_frames() / len(s.windows)
    assert kinds["motion"] > 0


def test_backlog_gives_every_seed_the_same_sizes():
    traffic = small_cell("mv1080_events").traffic
    a = backlog.generate(traffic, 25.0, 1, "/in")
    b = backlog.generate(traffic, 25.0, 2 ** 31 + 12345, "/in")
    block = traffic["block_files"]
    for lo in range(0, len(a) - block + 1, block):
        assert sorted(s.frames for s in a[lo:lo + block]) == \
            sorted(s.frames for s in b[lo:lo + block])
    assert [s.windows for s in a] != [s.windows for s in b]
    assert [s.windows for s in a] == [
        s.windows for s in backlog.generate(traffic, 25.0, 1, "/in")]


def test_control_is_refused_and_the_reference_passes():
    for name in ("mv1080_nvr", "sad1080_nvr"):
        specs, ref = control.build(small_cell(name, files=24), 3, "/in")
        assert check.passes(control.readings(specs, ref))
        numbers = control.readings(specs, ref,
                                   control.held_every_second(ref))
        assert not check.passes(numbers)
        assert numbers["files_wrong_motion"] >= 1


@pytest.mark.parametrize("name", ["mv1080_events", "sad1080_nvr"])
def test_the_programs_cpu_build_agrees_with_the_reference(name):
    result = run_small(name)
    assert result["checks"]["files_checked"]["value"] == 24
    assert result["correct"], result["faults"]
