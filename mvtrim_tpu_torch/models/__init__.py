"""Detector models: the codec-MV cluster detector and the pixel-domain
SAD detector."""

from .mv_detector import MVClusterDetector
from .sad_detector import SADDetector

__all__ = ["MVClusterDetector", "SADDetector"]
