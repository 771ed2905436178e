"""CLI entry: ``python -m mvtrim_tpu_torch <input> <output>``
(reference src/main.cpp:35-101).

Same dispatch contract as the reference and ``mvtrim_tpu.cli``: a
directory input selects batch mode (extension-filtered, sorted), a file
input selects single-file mode; usage error exits 1; batch mode exits with
the number of failed files.
"""

from __future__ import annotations

import os
import sys

from .core.config import Config
from .utils import logging as log
from .batch.batch import BatchProcessor, list_videos
from .pipeline.pipeline import ProcessingPipeline


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        log.warn("Usage: python -m mvtrim_tpu_torch <input> <output>")
        return 1

    input_arg, output_arg = argv[0], argv[1]
    cfg = Config.from_env()

    if os.path.isdir(input_arg):
        os.makedirs(output_arg, exist_ok=True)
        log.info("Motion Trim - Batch Mode")
        log.info(f"Input directory: {input_arg}")
        log.info(f"Output directory: {output_arg}")

        files = list_videos(input_arg)
        if not files and not cfg.watch_mode:
            log.warn("No video files found in directory")
            return 0
        log.info(f"Found {len(files)} video files")

        processor = BatchProcessor(cfg.parallel_streams, cfg)
        return processor.process(files, output_arg, input_arg)

    log.info("Motion Trim - Single File Mode")
    log.info(f"Input: {input_arg}")
    log.info(f"Output: {output_arg}")
    if cfg.archive_mode:
        return run_archive(input_arg, output_arg, cfg)
    pipeline = ProcessingPipeline(
        input_arg, output_arg, stream_id=-1,
        num_threads=cfg.threads_per_stream, cfg=cfg)
    return pipeline.run()


def run_archive(input_arg: str, output_arg: str, cfg: Config) -> int:
    """MVT_ARCHIVE=1: shard one long video's scan over the device mesh
    (parallel/archive.py), then apply the usual cut decision."""
    from .core import oracle
    from .cut.executor import execute_cut
    from .parallel.archive import scan_archive

    log.phase("Archive Scan (mesh-sharded)...")
    try:
        segments, duration, stats = scan_archive(
            input_arg, cfg, decode_workers=cfg.decode_workers,
            checkpoint=cfg.checkpoint_path or None)
    except (OSError, RuntimeError) as e:
        log.error(f"Archive scan failed: {e}")
        return 1
    if not segments:
        log.warn("No motion found.")
        return 0
    time_removed, saved_pct = oracle.savings(segments, duration)
    is_cut, out_segments = oracle.decide_cut(segments, duration,
                                             cfg.min_savings_pct)
    if not is_cut:
        log.warn(f"Savings too low ({int(saved_pct)}%). Min required: "
                 f"{int(cfg.min_savings_pct)}%. Copying full stream.")
    log.phase("Cutting...")
    rc = execute_cut(input_arg, output_arg, out_segments, -1, cfg)
    if rc == 0:  # don't claim savings for a cut that produced no output
        log.print_cut_summary(duration, time_removed, saved_pct)
    return rc


if __name__ == "__main__":
    sys.exit(main())
