from .config import Config
from .types import GridGeometry, ScanTask, TimeSegment

__all__ = ["Config", "GridGeometry", "ScanTask", "TimeSegment"]
