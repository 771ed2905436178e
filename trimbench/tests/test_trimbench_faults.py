"""A whole run (the look for a card skipped, the program's CPU build) with
the timed path broken underneath: ``correct`` has to come out false for
each fault the cells can have.  The exchange between cards has no place
here: every cell runs on one card."""

from __future__ import annotations

import numpy as np
import pytest

from mvtrim_tpu_torch.cut import executor
from mvtrim_tpu_torch.models.mv_detector import MVClusterDetector
from mvtrim_tpu_torch.models.sad_detector import SADDetector
from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline

from trimbench_cases import run_small


def broken_resolver(break_motion):
    """Wrap MVClusterDetector.scan_bits_async so each resolver's answer
    goes through ``break_motion``."""
    real = MVClusterDetector.scan_bits_async

    def scan_bits_async(self, bits):
        resolve = real(self, bits)
        return lambda: break_motion(resolve())
    return scan_bits_async


def broken_luma(break_motion):
    real = SADDetector.scan_luma

    def scan_luma(self, luma, carry=None):
        return break_motion(real(self, luma, carry))
    return scan_luma


def unchanged(motion):
    """The step hands back its state untouched: nothing decided."""
    return np.zeros_like(motion)


def half_left_out(motion):
    """Only the first half of each batch decided."""
    out = motion.copy()
    out[len(out) // 2:] = False
    return out


def one_altered(motion):
    """One answer flipped where it is produced."""
    out = motion.copy()
    if len(out) > 1:
        out[1] = not out[1]
    return out


FAULTS = [unchanged, half_left_out, one_altered]


def test_unbroken_runs_are_correct():
    import torch

    threads = torch.get_num_threads()
    assert run_small("mv1080_events", files=12)["correct"]
    # the run sets the configuration's thread count and gives it back
    assert torch.get_num_threads() == threads


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_mv_scan_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(MVClusterDetector, "scan_bits_async",
                        broken_resolver(fault))
    result = run_small("mv1080_events", files=12)
    assert not result["correct"]
    assert result["checks"]["files_wrong_motion"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_sad_scan_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(SADDetector, "scan_luma", broken_luma(fault))
    result = run_small("sad1080_events", files=8)
    assert not result["correct"]
    assert result["checks"]["files_wrong_motion"]["value"] > 0


def test_an_altered_cut_is_not_correct(monkeypatch):
    real = executor.CutQueue.push

    def push(self, job):
        seg = job.segments[0]
        job.segments[0] = type(seg)(seg.start + 0.04, seg.end)
        real(self, job)
    monkeypatch.setattr(executor.CutQueue, "push", push)
    result = run_small("mv1080_events", files=12)
    assert not result["correct"]
    assert result["checks"]["files_wrong_cut"]["value"] > 0
    assert result["checks"]["files_wrong_motion"]["value"] == 0


def test_a_failing_scan_is_not_correct(monkeypatch):
    def scan_bits_async(self, bits):
        raise RuntimeError("planted fault")
    monkeypatch.setattr(MVClusterDetector, "scan_bits_async",
                        scan_bits_async)
    result = run_small("mv1080_events", files=6)
    assert not result["correct"]
    assert result["checks"]["files_failed"]["value"] == 6


def test_a_miscounted_scan_is_not_correct(monkeypatch):
    real = ProcessingPipeline._parallel_scan

    def _parallel_scan(self, kind, fps, width, height):
        result = real(self, kind, fps, width, height)
        result.frames_scanned -= 1
        return result
    monkeypatch.setattr(ProcessingPipeline, "_parallel_scan", _parallel_scan)
    result = run_small("mv1080_events", files=6)
    assert not result["correct"]
    assert result["checks"]["files_wrong_frames"]["value"] == 6
