"""Detector models: the codec-MV cluster detector."""

from .mv_detector import MVClusterDetector

__all__ = ["MVClusterDetector"]
