"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level name (``mvtrim_tpu_torch`` begins with ``mvtrim_tpu`` and
is the program), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from trimbench import harness, spec

JAX = {"jax", "jaxlib", "flax", "mvtrim_tpu"}


def sources():
    for root, _, names in os.walk(spec.PACKAGE_DIR):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(root, name)


def top_level_imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_no_jax_import(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted(p for p in sources()
                   if os.sep + "reference" + os.sep in p),
    ids=lambda p: os.path.relpath(p, spec.ROOT))
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | {"mvtrim_tpu_torch",
                                                 "torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mvtrim_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mvtrim_tpu.core", sys)
    assert harness.forbidden_modules() == ["mvtrim_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.argv = ['x'];"
            "from trimbench_cases import run_small;"
            "r = run_small('mv1080_events', files=4);"
            "from trimbench import harness;"
            "print(r['correct'], harness.forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [spec.ROOT, os.path.dirname(__file__)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "trimbench", "--workload", "mv1080_nvr",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
