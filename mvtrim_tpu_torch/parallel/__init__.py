"""Device mesh, sharded scan steps, archive streaming, multi-process init."""

from .archive import ScanCheckpoint, scan_archive
from .mesh import (build_mesh, shard_votes, sharded_scan_step,
                   stream_device_assignment)

__all__ = ["ScanCheckpoint", "scan_archive", "build_mesh", "shard_votes",
           "sharded_scan_step", "stream_device_assignment"]
