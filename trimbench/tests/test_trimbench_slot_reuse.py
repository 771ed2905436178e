"""The reader of ``slot_reuse_pct`` on spans made up by hand: pins over
the staged batches that began in the window, and nothing where the
program has no staging slots or launched nothing (the CPU build)."""

from __future__ import annotations

import importlib.util

import pytest

from trimbench import spec

from test_trimbench_program_spans import SPANS, span, traced_run

PINNED = SPANS + [
    span("detector.stage", 100, 101, parent=1, value=112500),
    span("detector.pin", 100, 100.5, parent=len(SPANS), value=2091008),
    span("detector.stage", 102, 103, parent=1, value=112500),
    span("detector.stage", 104, 105, parent=1, value=112500),
    span("detector.pin", 1001, 1002, value=2091008),  # after the window
]


def read(run):
    return spec.metric_reader("slot_reuse_pct")(run)


def test_pins_over_the_batches_staged_in_the_window():
    # five detector.stage spans in the window (two in SPANS), one pin
    assert read(traced_run(PINNED)) == pytest.approx(100 * (1 - 1 / 5))
    no_pins = [s for s in PINNED if s.name != "detector.pin"]
    assert read(traced_run(no_pins)) == pytest.approx(100.0)


def test_nothing_to_read(monkeypatch):
    unlaunched = [s._replace(launches=0) for s in PINNED]
    for spans in (None, [], unlaunched):
        assert read(traced_run(spans)) is None
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name.endswith(".staging")
        else real(name, *a))
    assert read(traced_run(PINNED)) is None
