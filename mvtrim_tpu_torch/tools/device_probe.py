"""device_probe — accelerator/host capability report.

The counterpart of ``mvtrim_tpu/tools/device_probe.py``: the CUDA
inventory (name, SM count, memory, compute capability of each card), the
scan geometry at 1080p, and the host CPU budget for decode workers.
Prints JSON.

Usage: python -m mvtrim_tpu_torch.tools.device_probe
"""

from __future__ import annotations

import json
import sys

import torch


def cuda_devices() -> list[dict]:
    """One record per CUDA device; empty without one."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        out.append({"index": i, "name": p.name,
                    "sm_count": p.multi_processor_count,
                    "memory_bytes": p.total_memory,
                    "capability": f"{p.major}.{p.minor}"})
    return out


def probe() -> dict:
    from ..core.config import Config
    from ..core.types import GridGeometry
    from ..utils import system

    cfg = Config.from_env()
    geom_1080 = GridGeometry.build(1920, 1080, cfg)
    return {
        "devices": cuda_devices(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "host": {
            "cpu_limit": system.detect_cpu_limit(),
            "available_cpus": system.available_cpus(),
            "auto_parallel_streams": system.calculate_parallel_streams(
                cfg.threads_per_stream),
        },
        "scan_geometry_1080p": {
            "grid": [geom_1080.gh, geom_1080.gw],
            "vertical_margin": geom_1080.y_min,
            # the bits payload as the scanner packs it
            "bytes_per_frame": geom_1080.gh * ((geom_1080.gw + 7) // 8),
        },
        "config": {
            "device_batch": cfg.device_batch,
            "scan_backend": cfg.scan_backend,
            "pipeline_mode": cfg.pipeline_mode,
        },
    }


def main(argv: list[str] | None = None) -> int:
    print(json.dumps(probe(), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
