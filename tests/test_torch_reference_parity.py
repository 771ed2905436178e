"""The port against the compiled C++ reference, concat list for list.

The twin of tests/test_reference_parity.py for ``python -m
mvtrim_tpu_torch`` (CPU build, ``MVT_SCAN_BACKEND=torch``): the reference
(``parity/build_reference.sh``, its checkout at MVT_REFERENCE_DIR) and the
port run on the same synthetic clips under the same knobs, each cut
captured by a stand-in, and the concat lists must be byte-identical.
Also ``python -m mvtrim_tpu_torch.bench.compare_reference`` end to end on
a short clip.  Skips (never fails) where the reference cannot be built.
"""

import subprocess

import pytest
from test_reference_parity import CONFIGS

from mvtrim_tpu_torch.bench import compare_reference
from mvtrim_tpu_torch.io import native


@pytest.fixture(scope="session")
def reference_bin():
    try:
        return compare_reference.harness().ensure_reference(
            compare_reference.BUILD_DIR)
    except (subprocess.SubprocessError, OSError) as e:
        pytest.skip(f"reference build unavailable: {e}")


@pytest.fixture(scope="session")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    specs = {
        "two_windows": dict(width=640, height=480, duration=20.0,
                            motion_windows=((2.0, 5.0), (12.0, 14.0))),
        "bframes": dict(width=320, height=240, duration=12.0,
                        motion_windows=((2.0, 5.0),), b_frames=2),
        "mpeg4_avi": dict(width=320, height=240, duration=12.0,
                          codec="mpeg4", motion_windows=((3.0, 6.0),)),
    }
    paths = {}
    for name, kw in specs.items():
        path = str(d / (name + (".avi" if "avi" in name else ".mp4")))
        native.synthesize(path, fps=25.0, **{"codec": "libx264", **kw})
        paths[name] = path
    return paths


def both_concats(reference_bin, clip, knobs, tmp_path):
    binary, shim = reference_bin
    _, ref = compare_reference.harness().run_reference(
        binary, shim, clip, str(tmp_path / "ref_out.mp4"),
        str(tmp_path / "ref_concat.txt"), knobs)
    _, ours, _ = compare_reference.run_ours(
        clip, str(tmp_path / "our_out.mp4"), str(tmp_path / "our.txt"),
        dict(knobs, MVT_SCAN_BACKEND="torch", MVT_LOG="0"))
    return ref, ours


class TestConcatListParity:
    @pytest.mark.parametrize("knobs", CONFIGS)
    def test_two_windows(self, reference_bin, clips, tmp_path, knobs):
        ref, ours = both_concats(reference_bin, clips["two_windows"], knobs,
                                 tmp_path)
        assert ref is not None and ours == ref

    @pytest.mark.parametrize("name", ["bframes", "mpeg4_avi"])
    def test_other_clips(self, reference_bin, clips, tmp_path, name):
        ref, ours = both_concats(reference_bin, clips[name],
                                 {"VECTORS_NEEDED": "1"}, tmp_path)
        assert ref is not None and ours == ref


def test_compare_reference_main(reference_bin, monkeypatch, capsys):
    monkeypatch.setenv("MVT_SCAN_BACKEND", "torch")
    assert compare_reference.main(["--duration", "12", "--runs", "1",
                                   "--width", "320", "--height",
                                   "240"]) == 0
    assert '"concat_lists_identical": true' in capsys.readouterr().out
