"""Typed configuration mirroring the reference's env-var knob set.

The reference reads 14 environment variables lazily with memoized getters
(reference: include/motion_trim/config.hpp:56-175).  We reproduce the exact
names and *code* defaults (the reference README documents different values;
the code wins — see SURVEY.md §5 "Known inconsistencies").

Additional TPU-only knobs are grouped at the bottom and are all prefixed
``MVT_`` so the reference's namespace stays untouched.
"""

from __future__ import annotations

import dataclasses
import os


def _env_float(name: str, default: float) -> float:
    val = os.environ.get(name)
    return float(val) if val not in (None, "") else default


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else default


def _env_bool(name: str, default: bool) -> bool:
    val = os.environ.get(name)
    if val in (None, ""):
        return default
    return int(val) != 0


def _env_str(name: str, default: str) -> str:
    val = os.environ.get(name)
    return val if val not in (None, "") else default


@dataclasses.dataclass(frozen=True)
class Config:
    """Immutable config snapshot.

    Mirrors reference config.hpp getters:
      mv_threshold_sq   config.hpp:56  (default 16.0)
      block_size        config.hpp:62  (default 16)
      block_shift       config.hpp:68  (default 4)
      vectors_needed    config.hpp:74  (default 2, uint8)
      clusters_needed   config.hpp:80  (default 2)
      vertical_mask     config.hpp:86  (default 0.05)
      max_gap_sec       config.hpp:92  (default 5.0)
      padding_sec       config.hpp:98  (default 0.5)
      chunk_duration_sec config.hpp:104 (default 30.0)
      target_fps        config.hpp:113 (default 0.0)
      min_savings_pct   config.hpp:122 (default 5.0)
      parallel_streams  config.hpp:136 (default 0 = auto)
      threads_per_stream config.hpp:163 (default 0 = auto)
      watch_mode        config.hpp:172 (default false)
    """

    # --- analysis knobs (hot path) ---
    mv_threshold_sq: float = 16.0
    block_size: int = 16
    block_shift: int = 4
    vectors_needed: int = 2          # saturating uint8 vote threshold
    clusters_needed: int = 2
    vertical_mask: float = 0.05

    def __post_init__(self):
        # the reference stores this as uint8 (config.hpp:74 /
        # `const uint8_t vec_need`, motion_scanner.cpp:272): 256 wraps
        # to 0, -1 to 255.  from_env() already truncates; mirror it for
        # programmatic construction so the two surfaces agree.
        object.__setattr__(self, "vectors_needed",
                           self.vectors_needed & 0xFF)

    # --- segmentation knobs ---
    max_gap_sec: float = 5.0
    padding_sec: float = 0.5
    min_savings_pct: float = 5.0

    # --- scan scheduling knobs ---
    chunk_duration_sec: float = 30.0
    target_fps: float = 0.0

    # --- batch knobs ---
    parallel_streams: int = 0
    threads_per_stream: int = 0
    watch_mode: bool = False

    # --- TPU-native additions (not in reference) ---
    device_batch: int = 2048         # frames per device dispatch (fewer, larger
                                     # dispatches amortize per-dispatch cost)
    scan_backend: str = "auto"       # auto | tpu | xla | oracle
    ffmpeg_bin: str = ""             # optional external ffmpeg for the cut
    sad_threshold: float = 12.0      # mean-abs-diff per-pixel threshold (SAD path)
    decode_workers: int = 0          # host decode threads (0 = auto)
    pipeline_mode: str = "auto"      # mv | sad | auto (auto: SAD when no MVs)
    profile_dir: str = ""            # write jax.profiler traces here
    metrics_json: str = ""           # append per-video metrics JSON lines here
    archive_mode: bool = False       # single-file mode: shard scan over mesh
    checkpoint_path: str = ""        # archive-scan resume sidecar (JSONL)
    heatmap_path: str = ""           # write a spatial activity JSON per video
    scan_input: str = "bits"         # bits | grids | mv_raw (H2D payload)
    mv_capacity: int = 8192          # raw-MV rows per frame (mv_raw path)
    rss_limit_mb: float = 0.0        # watch-mode RSS watchdog (0 = off)
    compile_cache_dir: str = ""      # persistent jit-compile cache directory
                                     # ("" = off); collapses cold-process
                                     # warmup(jit) to a cache read
    cut_cpuset: str = ""             # pin cut work to these CPUs ("0-3,8"
                                     # grammar).  Analog of the reference
                                     # wrapping its ffmpeg child in
                                     # `taskset -c` (pipeline.cpp:500-515):
                                     # external children inherit the
                                     # spawning thread's affinity (no
                                     # preexec_fn — deadlock-prone in
                                     # threaded processes), the native
                                     # remux pins the cut thread
    chunk_frames_cap: int = 0        # max frames per native scan call
                                     # (0 = auto).  Saturated calls resume
                                     # from the exact stream position with
                                     # the frame-skip phase carried, so the
                                     # cap never changes decisions — it
                                     # bounds host memory per decode call

    @classmethod
    def from_env(cls) -> "Config":
        """Build a snapshot from the environment (names identical to reference)."""
        return cls(
            mv_threshold_sq=_env_float("MV_THRESHOLD_SQ", 16.0),
            block_size=_env_int("BLOCK_SIZE", 16),
            block_shift=_env_int("BLOCK_SHIFT", 4),
            # reference truncates via static_cast<uint8_t> (config.hpp:74-77)
            # i.e. wraps mod 256 — not a clamp
            vectors_needed=_env_int("VECTORS_NEEDED", 2) & 0xFF,
            clusters_needed=_env_int("CLUSTERS_NEEDED", 2),
            vertical_mask=_env_float("VERTICAL_MASK", 0.05),
            max_gap_sec=_env_float("MAX_GAP_SEC", 5.0),
            padding_sec=_env_float("PADDING_SEC", 0.5),
            chunk_duration_sec=_env_float("CHUNK_DURATION_SEC", 30.0),
            target_fps=_env_float("TARGET_FPS", 0.0),
            min_savings_pct=_env_float("MIN_SAVINGS_PCT", 5.0),
            parallel_streams=_env_int("PARALLEL_STREAMS", 0),
            threads_per_stream=_env_int("THREADS_PER_STREAM", 0),
            watch_mode=_env_bool("WATCH_MODE", False),
            device_batch=_env_int("MVT_DEVICE_BATCH", 2048),
            scan_backend=_env_str("MVT_SCAN_BACKEND", "auto"),
            ffmpeg_bin=_env_str("MVT_FFMPEG_BIN", ""),
            sad_threshold=_env_float("MVT_SAD_THRESHOLD", 12.0),
            decode_workers=_env_int("MVT_DECODE_WORKERS", 0),
            pipeline_mode=_env_str("MVT_PIPELINE", "auto"),
            profile_dir=_env_str("MVT_PROFILE_DIR", ""),
            metrics_json=_env_str("MVT_METRICS_JSON", ""),
            archive_mode=_env_bool("MVT_ARCHIVE", False),
            checkpoint_path=_env_str("MVT_CHECKPOINT", ""),
            heatmap_path=_env_str("MVT_HEATMAP", ""),
            scan_input=_env_str("MVT_SCAN_INPUT", "bits"),
            mv_capacity=_env_int("MVT_MV_CAPACITY", 8192),
            rss_limit_mb=_env_float("MVT_RSS_LIMIT_MB", 0.0),
            compile_cache_dir=_env_str("MVT_COMPILE_CACHE", ""),
            cut_cpuset=_env_str("MVT_CUT_CPUSET", ""),
            chunk_frames_cap=_env_int("MVT_CHUNK_FRAMES_CAP", 0),
        )

    # --- derived geometry (reference motion_scanner.cpp:190-196) ---

    def grid_dims(self, width: int, height: int) -> tuple[int, int]:
        """(gw, gh) — ceil-divide frame dims by block size via shift."""
        gw = (width + self.block_size - 1) >> self.block_shift
        gh = (height + self.block_size - 1) >> self.block_shift
        return gw, gh

    def vertical_margin(self, gh: int) -> int:
        """Rows ignored at top/bottom: int(gh * vertical_mask).

        Reference truncates float (motion_scanner.cpp:196).
        """
        return int(gh * self.vertical_mask)

    def frame_skip(self, video_fps: float) -> int:
        """Analyze every Nth frame (reference motion_scanner.cpp:309-313)."""
        if self.target_fps > 0 and self.target_fps < video_fps:
            return int(video_fps / self.target_fps)
        return 1
