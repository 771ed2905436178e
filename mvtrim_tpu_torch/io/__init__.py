from .native import (MVT_MODE_LUMA, MVT_MODE_MV, MVT_MODE_MV_FULL,
                     ScanTiming, VideoReader, cut, synthesize)

__all__ = ["MVT_MODE_LUMA", "MVT_MODE_MV", "MVT_MODE_MV_FULL",
           "ScanTiming", "VideoReader", "cut", "synthesize"]
