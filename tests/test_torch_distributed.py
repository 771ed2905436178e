"""mvtrim_tpu_torch's multi-process archive scan, as gloo subprocesses.

The twins of tests/test_distributed.py: two or four ranks join one
``torch.distributed`` group through ``parallel.distributed.initialize``
(torchrun's variables), each decodes a disjoint chunk slice of the clip
and decides it on its own CPU shards (``MVT_SCAN_BACKEND=torch``), and
every rank must return the segments of the JAX package's archive scan and
of the NumPy oracle over the same clip, exactly.  Also: a rank with zero
frames still joins every collective, a killed job resumes from its
per-rank sidecars, a resharded resume is refused, float64 timestamps
cross ranks bit for bit, and the CPU build never initialises CUDA.
Each spawn has its own timeout.
"""

import json
import os
import socket
import struct
import subprocess
import sys
import time

import pytest

from mvtrim_tpu.core.config import Config as JaxConfig
from mvtrim_tpu.parallel.archive import scan_archive as jax_scan_archive
from mvtrim_tpu.parallel.mesh import build_mesh as jax_build_mesh
from mvtrim_tpu_torch.core import Config, GridGeometry, oracle
from mvtrim_tpu_torch.io import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_raw(worker_src: str, n_procs: int, extra_env=None,
               timeout: float = TIMEOUT):
    """n ranks of ``worker_src`` joined into one gloo group; returns
    [(returncode, stdout, stderr)] in rank order, every rank done within
    ``timeout`` seconds of the call."""
    port = _free_port()
    procs = []
    for rank in range(n_procs):
        env = dict(os.environ)
        for k in ("JAX_NUM_CPU_DEVICES", "XLA_FLAGS"):
            env.pop(k, None)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n_procs), RANK=str(rank),
                   LOCAL_RANK=str(rank), MVT_SCAN_BACKEND="torch",
                   PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
        env.update(extra_env or {})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker_src], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            o, e = p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _spawn(worker_src: str, n_procs: int, extra_env=None):
    results = []
    for rc, out, err in _spawn_raw(worker_src, n_procs, extra_env):
        assert rc == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


_WORKER = """
import json, os
from mvtrim_tpu_torch.parallel import distributed

ok = distributed.initialize()
assert ok and distributed.initialize(), "the group did not form"
import torch
from mvtrim_tpu_torch.parallel.distributed import allgather_ints, world
size, rank = world()
print(json.dumps({"multi": ok, "size": size, "rank": rank,
                  "gathered": allgather_ints([rank + 1]).ravel().tolist()}))
"""


def test_two_rank_initialize_and_collective():
    results = _spawn(_WORKER, 2)
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert r["multi"] is True and r["size"] == 2
        assert sorted(r["gathered"]) == [1, 2]


_ARCHIVE_WORKER = """
import dataclasses, json, os
from mvtrim_tpu_torch.parallel import distributed

assert distributed.initialize(), "the group did not form"
import torch
from mvtrim_tpu_torch.core import Config
from mvtrim_tpu_torch.parallel.archive import scan_archive_multiprocess
from mvtrim_tpu_torch.parallel.mesh import build_mesh

abort_after = int(os.environ.get("MVT_TEST_ABORT_AFTER", "0"))

def cb(i, n):
    # fault injection: exit hard after the i-th dispatch; sidecar appends
    # of the chunks completed so far are already on disk
    if abort_after and i + 1 >= abort_after:
        os._exit(3)

shards = int(os.environ.get("MVT_TEST_SHARDS", "0"))
# the environment's backend (MVT_SCAN_BACKEND=torch: the CPU build)
cfg = dataclasses.replace(Config.from_env(), chunk_duration_sec=float(
    os.environ["MVT_TEST_CHUNK"]))
segments, duration, stats = scan_archive_multiprocess(
    os.environ["MVT_TEST_CLIP"], cfg,
    mesh=build_mesh(shards) if shards else None,
    frames_per_device=int(os.environ.get("MVT_TEST_FPD", "16")),
    checkpoint=os.environ.get("MVT_TEST_CKPT") or None, progress_cb=cb)
print(json.dumps({
    "rank": distributed.world()[1],
    "segments": [[s.start, s.end] for s in segments],
    "duration": duration,
    "cuda_initialized": torch.cuda.is_initialized(),
    **{k: stats[k] for k in ("frames_scanned", "motion_frames",
                             "motion_frames_psum", "dispatches", "mesh",
                             "processes", "resumed_chunks_local")}}))
"""


def _expected(clip: str, chunk: float):
    """The JAX package's single-process archive scan and the NumPy oracle
    over the whole clip: (segments, frames, motion frames)."""
    jsegs, _, jstats = jax_scan_archive(
        clip, JaxConfig(chunk_duration_sec=chunk),
        mesh=jax_build_mesh(2, sweep=1), frames_per_device=16,
        payload="bits")
    cfg = Config(chunk_duration_sec=chunk)
    with native.VideoReader(clip) as r:
        geom = GridGeometry.build(r.width, r.height, cfg)
        grids, pts = r.scan_grids(
            0.0, r.duration + 1, threshold_sq=cfg.mv_threshold_sq,
            block_shift=cfg.block_shift, gw=geom.gw, gh=geom.gh,
            y_min=geom.y_min, y_max=geom.y_max, max_frames=400)
        duration = r.duration
    counts = oracle.count_clusters_batch(
        grids, vectors_needed=cfg.vectors_needed, y_min=geom.y_min,
        y_max=geom.y_max)
    m = counts >= oracle.effective_clusters_needed(cfg.clusters_needed)
    ts = oracle.merge_timestamps(pts[m].tolist())
    segs = [[s.start, s.end] for s in oracle.segments_from_timestamps(
        ts, max_gap_sec=cfg.max_gap_sec, padding_sec=cfg.padding_sec,
        duration=duration)]
    assert [[s.start, s.end] for s in jsegs] == segs
    assert jstats["motion_frames"] == int(ts.size)
    return segs, len(pts), int(ts.size)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    out = {}
    for name, dur, windows in (("ten", 10.0, ((2.0, 4.0), (7.0, 8.0))),
                               ("short", 2.0, ((0.5, 1.5),)),
                               ("six", 6.0, ((1.0, 3.0),))):
        out[name] = str(d / f"{name}.mp4")
        native.synthesize(out[name], width=320, height=240, fps=25.0,
                          duration=dur, codec="libx264",
                          motion_windows=windows)
    return out


@pytest.mark.parametrize("n_procs,shards,fpd,chunk", [
    (2, 4, 16, 3.0),     # test_distributed.py:119, 2 ranks x 4 shards
    (4, 2, 8, 2.0),      # test_distributed.py:307, 4 ranks x 2 shards
])
def test_multirank_archive_matches_jax_and_oracle(clips, n_procs, shards,
                                                  fpd, chunk):
    results = _spawn(_ARCHIVE_WORKER, n_procs, {
        "MVT_TEST_CLIP": clips["ten"], "MVT_TEST_SHARDS": str(shards),
        "MVT_TEST_FPD": str(fpd), "MVT_TEST_CHUNK": str(chunk)})
    expect, n_pts, n_motion = _expected(clips["ten"], chunk)
    assert [r["rank"] for r in results] == list(range(n_procs))
    for r in results:
        assert r["segments"] == expect and len(expect) > 0
        assert r["frames_scanned"] == n_pts
        assert r["motion_frames"] == n_motion > 0
        # the summed counts take every True decision before the dedupe
        assert r["motion_frames_psum"] >= r["motion_frames"]
        assert r["dispatches"] >= 2
        assert r["mesh"] == {"data": n_procs * shards, "sweep": 1}
        assert r["processes"] == n_procs


def test_multirank_archive_with_zero_frame_rank(clips):
    """A clip shorter than one chunk gives rank 1 ZERO chunks: it must
    still join every dispatch's collective and the timestamp gather, and
    reach the same segments (test_distributed.py:172)."""
    results = _spawn(_ARCHIVE_WORKER, 2, {
        "MVT_TEST_CLIP": clips["short"], "MVT_TEST_SHARDS": "4",
        "MVT_TEST_CHUNK": "3.0"})
    expect, n_pts, n_motion = _expected(clips["short"], 3.0)
    for r in results:
        assert r["segments"] == expect and len(expect) > 0
        assert r["frames_scanned"] == n_pts
        assert r["motion_frames"] == n_motion > 0
        assert r["dispatches"] >= 1


def test_multirank_checkpoint_kill_and_resume(clips, tmp_path):
    """Kill the whole job after its first dispatch, restart with the same
    topology: recorded chunks are skipped and the segments are the
    uninterrupted ones; a third run resumes everything
    (test_distributed.py:332)."""
    ck = str(tmp_path / "mp.ckpt")
    env = {"MVT_TEST_CLIP": clips["ten"], "MVT_TEST_CKPT": ck,
           "MVT_TEST_SHARDS": "4", "MVT_TEST_CHUNK": "2.0"}
    out = _spawn_raw(_ARCHIVE_WORKER, 2, dict(env, MVT_TEST_ABORT_AFTER="1"))
    assert all(rc == 3 for rc, _, _ in out), [(rc, e[-500:])
                                              for rc, _, e in out]
    sidecars = [f"{ck}.p0", f"{ck}.p1"]
    assert all(os.path.exists(s) for s in sidecars)
    recs = sum(1 for s in sidecars for line in open(s) if '"chunk"' in line)
    assert recs >= 1, "the kill came before any chunk completed"

    results = _spawn(_ARCHIVE_WORKER, 2, env)
    expect, n_pts, n_motion = _expected(clips["ten"], 2.0)
    assert sum(r["resumed_chunks_local"] for r in results) >= 1
    for r in results:
        assert r["segments"] == expect and len(expect) > 0
        assert r["motion_frames"] == n_motion > 0
        assert r["frames_scanned"] < n_pts

    for r in _spawn(_ARCHIVE_WORKER, 2, env):
        assert r["segments"] == expect
        assert r["frames_scanned"] == 0
        assert r["resumed_chunks_local"] >= 1


def test_multirank_checkpoint_refuses_resharded_topology(clips, tmp_path):
    """Sidecars pin (process_count, process_index): a restart with another
    world size must refuse them (test_distributed.py:384)."""
    ck = str(tmp_path / "mp2.ckpt")
    env = {"MVT_TEST_CLIP": clips["six"], "MVT_TEST_CKPT": ck,
           "MVT_TEST_FPD": "8", "MVT_TEST_CHUNK": "2.0"}
    _spawn(_ARCHIVE_WORKER, 2, env)
    out = _spawn_raw(_ARCHIVE_WORKER, 4, env)
    failing = [e for rc, _, e in out if rc != 0]
    assert failing, "the resharded resume was not refused"
    assert any("different scan" in e for e in failing)


def test_refused_resume_stops_every_rank_promptly(clips, tmp_path):
    """The refusal is agreed across ranks before the scan's first
    collective: every rank of a 4-rank resume over 2-rank sidecars exits
    nonzero within 60 s (none waits for the others in a collective), the
    refusing ranks with the "different scan" error, the rest naming
    them."""
    ck = str(tmp_path / "mp2.ckpt")
    env = {"MVT_TEST_CLIP": clips["six"], "MVT_TEST_CKPT": ck,
           "MVT_TEST_FPD": "8", "MVT_TEST_CHUNK": "2.0"}
    _spawn(_ARCHIVE_WORKER, 2, env)
    out = _spawn_raw(_ARCHIVE_WORKER, 4, env, timeout=60)
    assert [rc != 0 for rc, _, _ in out] == [True] * 4
    for rank, (_, _, err) in enumerate(out):
        if rank < 2:
            assert "different scan" in err, err[-2000:]
        else:
            assert "rank(s) [0, 1] refused" in err, err[-2000:]


_F64_WORKER = """
import json, struct
import numpy as np
from mvtrim_tpu_torch.parallel import distributed

assert distributed.initialize()
size, rank = distributed.world()
# values float32 cannot hold: thirds, tenths, a 1e-9 step past an hour
x = np.array([1 / 3 + rank, 0.1 * (rank + 7), 3600.000000001 + rank,
              2.0 ** -40 * (rank + 1)], np.float64)
g = distributed.allgather_f64(x)
print(json.dumps({"rank": rank,
                  "bits": [[struct.pack("<d", v).hex() for v in row]
                           for row in g.tolist()]}))
"""


def test_float64_timestamps_cross_ranks_bit_exact():
    """Segments are cut at %.2f of float64 timestamps: a float32 gather
    would move them (mvtrim_tpu/parallel/archive.py:101-106).  Every rank
    must read every rank's float64 values bit for bit."""
    results = _spawn(_F64_WORKER, 3)
    want = [[struct.pack("<d", v).hex() for v in
             (1 / 3 + r, 0.1 * (r + 7), 3600.000000001 + r,
              2.0 ** -40 * (r + 1))] for r in range(3)]
    for r in results:
        assert r["bits"] == want


def test_cpu_build_never_initialises_cuda(clips):
    """The hermetic dry run: a gloo scan on the CPU build, with the
    default per-rank mesh, must leave CUDA uninitialised on every rank."""
    results = _spawn(_ARCHIVE_WORKER, 2, {
        "MVT_TEST_CLIP": clips["six"], "MVT_TEST_CHUNK": "2.0"})
    for r in results:
        assert r["cuda_initialized"] is False
        assert r["mesh"] == {"data": 2, "sweep": 1}
