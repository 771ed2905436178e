"""One short run of each cell on the card: the result line is whole and
``correct``.  Skips without a CUDA card (decided inside the test)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from trimbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("workload",
                         [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "trimbench", "--workload", workload,
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert list(result)[-1] == "checks"
