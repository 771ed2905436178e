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
        log.error("MVT_ARCHIVE=1 (the sharded archive scan) is not ported "
                  "to mvtrim_tpu_torch yet: ROADMAP.md queue 1 item 11")
        return 1
    pipeline = ProcessingPipeline(
        input_arg, output_arg, stream_id=-1,
        num_threads=cfg.threads_per_stream, cfg=cfg)
    return pipeline.run()


if __name__ == "__main__":
    sys.exit(main())
