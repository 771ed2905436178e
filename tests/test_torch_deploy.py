"""The port's deployment: its image, compose service, wheel and kernel cache.

The counterparts of tests/test_deploy.py's checks, on
``mvtrim_tpu_torch/deploy/``: no docker runs here, so the Dockerfile and
compose file are parsed and every claim they make is checked against the
repository.  Then the wheel: built in a temporary directory, it must carry
every CUDA source and header, and installed from it the port must find its
sources and resolve its kernel library under MVT_COMPILE_CACHE.  Last, the
library is loaded, never rebuilt, where the file for these sources exists.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import zipfile

import pytest

from mvtrim_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "mvtrim_tpu_torch", "deploy")


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def stages() -> list[tuple[str, list[str]]]:
    """The Dockerfile's stages: (FROM line, its instruction lines with
    continuations joined, comments dropped)."""
    out: list[tuple[str, list[str]]] = []
    joined, cur = [], ""
    for line in _read(os.path.join(DEPLOY, "Dockerfile")).splitlines():
        if line.lstrip().startswith("#") or not line.strip():
            continue
        cur += line.rstrip("\\").strip() + " "
        if not line.rstrip().endswith("\\"):
            joined.append(cur.strip())
            cur = ""
    for line in joined:
        if line.startswith("FROM "):
            out.append((line, []))
        elif out:
            out[-1][1].append(line)
    return out


def env_of(lines: list[str], key: str) -> str:
    for line in lines:
        m = re.search(rf"\b{key}=(\S+)", line)
        if line.startswith("ENV ") and m:
            return m.group(1)
    raise AssertionError(f"no ENV {key}")


class TestDockerfile:
    def test_copy_sources_exist(self):
        """Every COPY from the build context (the repository's root) names
        a real path."""
        checked = 0
        for _, lines in stages():
            for line in lines:
                if not line.startswith("COPY ") or "--from=" in line:
                    continue
                *srcs, _dst = line.split()[1:]
                for src in srcs:
                    assert os.path.exists(os.path.join(REPO, src)), src
                    checked += 1
        assert checked >= 6  # native/, the port twice, pyproject, config...

    def test_ffmpeg_pin_clears_hevc_mv_bar(self):
        m = re.search(r"ffmpeg-(\d+)\.(\d+)",
                      _read(os.path.join(DEPLOY, "Dockerfile")))
        assert m, "no FFmpeg source version pinned"
        assert int(m.group(1)) >= 7

    def test_hevc_capability_gate_is_baked_into_the_build(self):
        runtime = stages()[-1][1]
        assert any(line.startswith("RUN ") and "hevc_mv_export_capable"
                   in line for line in runtime)

    def test_three_stages_devel_for_kernels_runtime_without_nvcc(self):
        froms = [f for f, _ in stages()]
        assert len(froms) == 3
        assert "devel" in froms[1] and froms[1].endswith("AS kernels")
        assert "runtime" in froms[2] and "devel" not in froms[2]

    def test_native_lib_env_matches_copy_destination(self):
        runtime = stages()[-1][1]
        lib = env_of(runtime, "MVT_NATIVE_LIB")
        workdir = [line.split()[1] for line in runtime
                   if line.startswith("WORKDIR ")][-1]
        assert any(re.fullmatch(
            r"COPY --from=media \S*libmvtrim_host\.so "
            + re.escape(os.path.relpath(lib, workdir)), line)
            for line in runtime), f"no COPY lands the native lib at {lib}"

    def test_compile_cache_matches_the_prebuilt_copy(self):
        """The kernel stage builds into its MVT_COMPILE_CACHE, the runtime
        stage copies that directory to its own MVT_COMPILE_CACHE."""
        (_, media), (_, kernels), (_, runtime) = stages()
        built = env_of(kernels, "MVT_COMPILE_CACHE")
        cache = env_of(runtime, "MVT_COMPILE_CACHE")
        assert f"COPY --from=kernels {built} {cache}" in runtime

    def test_prebuild_arch_is_the_build_modules(self):
        kernels = stages()[1][1]
        runs = [line for line in kernels
                if "-m mvtrim_tpu_torch.ops._build" in line]
        assert len(runs) == 1
        arch = re.search(r"--arch (\S+)", runs[0]).group(1)
        assert arch == _build.ARCH
        assert any(f"code={arch}" in flag for flag in _build.ARCH_FLAGS)

    def test_entrypoint_is_the_ports_console_script(self):
        runtime = stages()[-1][1]
        entry = [line for line in runtime if line.startswith("ENTRYPOINT")]
        assert entry == ['ENTRYPOINT ["motion_trim_torch"]']
        assert re.search(r'^motion_trim_torch = "mvtrim_tpu_torch\.cli:main"',
                         _read(os.path.join(REPO, "pyproject.toml")), re.M)

    def test_runtime_stage_installs_no_jax(self):
        (_, _), (_, kernels), (_, runtime) = stages()
        for line in kernels + runtime:
            assert "jax" not in line.lower(), line
            assert "mvtrim_tpu/" not in line, line
        installs = [line for line in runtime if "pip install" in line]
        assert any("--no-deps ." in line for line in installs)
        assert any("torch==" in line for line in installs)


class TestCompose:
    def test_parses_reserves_a_gpu_and_points_at_real_files(self):
        yaml = pytest.importorskip("yaml")
        doc = yaml.safe_load(_read(os.path.join(DEPLOY,
                                                "docker-compose.yml")))
        svc = doc["services"]["motion-trim-torch"]
        context = os.path.join(DEPLOY, svc["build"]["context"])
        assert os.path.samefile(context, REPO)
        assert os.path.samefile(
            os.path.join(context, svc["build"]["dockerfile"]),
            os.path.join(DEPLOY, "Dockerfile"))
        for env_file in svc["env_file"]:
            assert os.path.samefile(os.path.join(DEPLOY, env_file),
                                    os.path.join(REPO, "config",
                                                 "motion_trim.env"))
        assert svc["environment"]["WATCH_MODE"] == "1"
        vols = "\n".join(svc["volumes"])
        assert "/input:ro" in vols and "/output:rw" in vols
        assert len(svc["volumes"]) == 2     # no compile-cache volume
        assert "volumes" not in doc
        assert svc["restart"] == "unless-stopped"
        assert svc["command"] == ["/input", "/output"]
        res = svc["deploy"]["resources"]
        assert res["limits"]["memory"]
        (gpu,) = res["reservations"]["devices"]
        assert gpu["driver"] == "nvidia" and gpu["capabilities"] == ["gpu"]
        assert gpu["count"] == 1
        assert "privileged" not in svc and "network_mode" not in svc


class TestEnvFileKnobs:
    def test_every_knob_is_read_by_the_port_or_listed_jax_only(self):
        keys = []
        for line in _read(os.path.join(REPO, "config",
                                       "motion_trim.env")).splitlines():
            m = re.match(r"#?([A-Z][A-Z0-9_]+)=", line.strip())
            if m:
                keys.append(m.group(1))
        assert len(keys) >= 30
        source = []
        for root, _, files in os.walk(os.path.join(REPO,
                                                   "mvtrim_tpu_torch")):
            source += [_read(os.path.join(root, f)) for f in files
                       if f.endswith(".py")]
        blob = "\n".join(source)
        unread = [k for k in keys
                  if f'"{k}"' not in blob and f"'{k}'" not in blob]
        # the README's one bullet of JAX-only knobs
        bullets = _read(os.path.join(REPO, "README.md")).split("\n- ")
        jax_only = [b for b in bullets if b.startswith("JAX-only")]
        assert len(jax_only) == 1
        listed = set(re.findall(r"`([A-Z][A-Z0-9_]+)`", jax_only[0]))
        assert set(unread) == listed, (unread, listed)


@pytest.fixture(scope="module")
def wheel(tmp_path_factory) -> str:
    """A wheel of the repository, built in a temporary copy of it."""
    src = tmp_path_factory.mktemp("src")
    shutil.copy(os.path.join(REPO, "pyproject.toml"), src)
    for pkg in ("mvtrim_tpu", "mvtrim_tpu_torch"):
        shutil.copytree(os.path.join(REPO, pkg), src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
    dist = tmp_path_factory.mktemp("dist")
    subprocess.run([sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
                    "--no-build-isolation", "-q", "-w", str(dist)],
                   cwd=src, check=True, capture_output=True, timeout=300)
    (whl,) = glob.glob(str(dist / "*.whl"))
    return whl


class TestWheel:
    def test_carries_every_cuda_source_and_header(self, wheel):
        names = set(zipfile.ZipFile(wheel).namelist())
        want = {os.path.relpath(p, REPO)
                for p in _build.sources() + _build.headers()}
        assert len(want) >= 8
        assert want <= names, want - names

    def test_installed_port_finds_its_sources_and_cache(self, wheel,
                                                        tmp_path):
        """Installed from the wheel (outside a checkout): the sources are
        beside the package, the library resolves under MVT_COMPILE_CACHE,
        and without it under ~/.cache/mvtrim_tpu/torch."""
        target = tmp_path / "site"
        subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                        "-q", "--target", str(target), wheel], check=True,
                       capture_output=True, timeout=300)
        probe = ("import json, os\n"
                 "from mvtrim_tpu_torch.ops import _build\n"
                 "print(json.dumps({'file': _build.__file__,\n"
                 "    'sources': len(_build.sources()),\n"
                 "    'headers': len(_build.headers()),\n"
                 "    'library': _build.library_path()}))\n")
        home = tmp_path / "home"
        out = {}
        for cache in ("cache", None):
            env = dict(os.environ, PYTHONPATH=str(target), HOME=str(home))
            env.pop("MVT_COMPILE_CACHE", None)
            if cache:
                env["MVT_COMPILE_CACHE"] = str(tmp_path / cache)
            r = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path,
                               env=env, capture_output=True, text=True,
                               timeout=120, check=True)
            out[cache] = json.loads(r.stdout.strip().splitlines()[-1])
        for rec in out.values():
            assert rec["file"].startswith(str(target))
            assert rec["sources"] == len(_build.sources())
            assert rec["headers"] == len(_build.headers())
        name = os.path.basename(_build.library_path())
        assert out["cache"]["library"] == str(tmp_path / "cache" / name)
        assert out[None]["library"] == str(
            home / ".cache" / "mvtrim_tpu" / "torch" / name)


class TestKernelCache:
    def test_library_path_lands_under_the_compile_cache(self, monkeypatch,
                                                        tmp_path):
        monkeypatch.setenv("MVT_COMPILE_CACHE", str(tmp_path))
        assert os.path.dirname(_build.library_path()) == str(tmp_path)
        monkeypatch.delenv("MVT_COMPILE_CACHE")
        # in a checkout, unset: the checkout's build/ directory
        assert os.path.dirname(_build.library_path()) == os.path.join(
            REPO, "build", "mvtrim_tpu_torch")

    def _prebuilt(self, monkeypatch, tmp_path, cdll):
        monkeypatch.setenv("MVT_COMPILE_CACHE", str(tmp_path))
        monkeypatch.setattr(_build, "_lib", None)
        monkeypatch.setattr(_build, "build_info", {})

        def no_nvcc():
            raise AssertionError("nvcc was reached")

        monkeypatch.setattr(_build, "_nvcc", no_nvcc)
        monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
        path = _build.library_path()
        open(path, "wb").close()
        return path

    def test_load_never_reaches_nvcc_when_the_library_exists(
            self, monkeypatch, tmp_path):
        class Lib:
            def __init__(self, path):
                self.path = path
                for name in _build.SIGNATURES:
                    setattr(self, name, type("Fn", (), {})())

        path = self._prebuilt(monkeypatch, tmp_path, Lib)
        lib = _build.load_library()
        assert lib.path == path and _build.build_info == {}
        fn = lib.mvt_mv_cluster_scratch
        assert fn.restype is ctypes.c_longlong
        assert fn.argtypes == _build.SIGNATURES["mvt_mv_cluster_scratch"]

    def test_a_library_that_will_not_load_raises_and_is_not_rebuilt(
            self, monkeypatch, tmp_path):
        def broken(path):
            raise OSError(f"{path}: invalid ELF header")

        self._prebuilt(monkeypatch, tmp_path, broken)
        with pytest.raises(OSError, match="invalid ELF header"):
            _build.load_library()
        assert _build.build_info == {}

    def test_build_entry_point_prints_the_path(self, monkeypatch, tmp_path,
                                               capsys):
        path = self._prebuilt(monkeypatch, tmp_path, lambda p: type(
            "Lib", (), {n: type("Fn", (), {})() for n in _build.SIGNATURES}
        )())
        assert _build.main(["--arch", _build.ARCH]) == 0
        assert capsys.readouterr().out.strip() == path

    def test_build_entry_point_refuses_another_arch(self):
        with pytest.raises(SystemExit) as e:
            _build.main(["--arch", "sm_80"])
        assert e.value.code == 2
