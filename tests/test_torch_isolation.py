"""mvtrim_tpu_torch stands alone: it imports nothing of mvtrim_tpu or jax.

Two checks.  An AST scan of every module of the port and of
``chip_smoke.py`` finds no import of ``mvtrim_tpu``, ``jax``, ``bench``
or ``benchmarks`` and no relative import that climbs out of the package.
A fresh interpreter imports every module of the port, runs ``python -m
mvtrim_tpu_torch`` on a synthesized clip, its archive scan
(``MVT_ARCHIVE=1``), the tune tool on it (also with ``--mesh``), the
bench's main on the CPU and the pipeline over a recorded payload
(``bench/replay.py``), and finds neither package in
``sys.modules`` afterwards (``mvtrim_tpu/__init__.py`` alone writes JAX
cache variables into the environment, so even a jax-free module of that
package must not load).
"""

import ast
import os
import subprocess
import sys

import pytest

from mvtrim_tpu_torch.io import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mvtrim_tpu_torch")


def port_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return sorted(out) + [os.path.join(REPO, "chip_smoke.py")]


def module_name(path: str) -> str:
    parts = os.path.relpath(path, REPO)[:-3].split(os.sep)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def forbidden(name: str) -> bool:
    """The JAX package, jax, and the JAX package's bench (``bench.py``,
    ``benchmarks/``)."""
    return (name in ("mvtrim_tpu", "jax", "bench", "benchmarks")
            or name.startswith(("mvtrim_tpu.", "jax.", "benchmarks.")))


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_the_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    rel = os.path.relpath(path, REPO)
    # package depth of the module: mvtrim_tpu_torch/ops/x.py is 2
    depth = rel.count(os.sep)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not forbidden(alias.name), (rel, alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                assert not forbidden(node.module or ""), (rel, node.module)
            else:
                assert node.level <= depth, \
                    f"{rel}: relative import leaves the package"


def test_modules_are_scanned():
    rels = {os.path.relpath(p, REPO) for p in port_files()}
    for must in ("mvtrim_tpu_torch/core/config.py",
                 "mvtrim_tpu_torch/io/native.py",
                 "mvtrim_tpu_torch/ops/mv_vote.py",
                 "mvtrim_tpu_torch/tools/tune.py",
                 "mvtrim_tpu_torch/bench/controls.py",
                 "mvtrim_tpu_torch/bench/__main__.py",
                 "mvtrim_tpu_torch/bench/soak_watch.py",
                 "mvtrim_tpu_torch/bench/replay.py",
                 "mvtrim_tpu_torch/bench/compare_reference.py",
                 "mvtrim_tpu_torch/ops/_build.py", "chip_smoke.py"):
        assert must in rels


def test_nothing_of_jax_loads(tmp_path):
    clip = str(tmp_path / "clip.mp4")
    native.synthesize(clip, width=320, height=240, fps=25.0, duration=6.0,
                      codec="libx264", motion_windows=((1.0, 3.0),))
    modules = sorted(module_name(p) for p in port_files()[:-1]
                     if not p.endswith("__main__.py"))
    code = (
        "import importlib, runpy, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import os\n"
        "from mvtrim_tpu_torch.cli import main\n"
        "from mvtrim_tpu_torch.tools import tune\n"
        f"assert tune.main([{clip!r}, '--thresholds', '16',"
        " '--vectors', '2', '--clusters', '2']) == 0\n"
        f"assert tune.main([{clip!r}, '--mesh', '2', '--scan-input',"
        " 'sad', '--thresholds', '12', '--clusters', '1,2']) == 0\n"
        "os.environ['MVT_ARCHIVE'] = '1'\n"
        f"assert main([{clip!r}, {str(tmp_path / 'arch.mp4')!r}]) == 0\n"
        "del os.environ['MVT_ARCHIVE']\n"
        "from mvtrim_tpu_torch.bench.__main__ import main as bench\n"
        "assert bench(['--device', 'cpu', '--quick']) == 0\n"
        f"sys.argv = ['mvtrim_tpu_torch', {clip!r},"
        f" {str(tmp_path / 'out.mp4')!r}]\n"
        "try:\n"
        "    runpy.run_module('mvtrim_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "from mvtrim_tpu_torch.bench import compare_reference, replay\n"
        "from mvtrim_tpu_torch.io import native\n"
        "from mvtrim_tpu_torch.pipeline.pipeline import ProcessingPipeline\n"
        "compare_reference.harness()\n"
        "fx = replay.load('C')\n"
        "real, native.VideoReader = native.VideoReader, replay.opener(fx)\n"
        f"src = {str(tmp_path / 'replay.mp4')!r}\n"
        "assert ProcessingPipeline(src, src + '.out', cfg=fx.config(\n"
        "    scan_backend='torch', ffmpeg_bin=replay.FAKE_FFMPEG)).run() == 0\n"
        "native.VideoReader = real\n"
        "bad = [m for m in sys.modules if m in ('jax', 'mvtrim_tpu')\n"
        "       or m.startswith(('jax.', 'mvtrim_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ISOLATED', len(sys.modules))\n")
    env = dict(os.environ, MVT_SCAN_BACKEND="torch",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED" in proc.stdout
    assert "archive scan (bits)" in proc.stdout
    assert os.path.exists(tmp_path / "out.mp4")
    assert os.path.exists(tmp_path / "arch.mp4")
