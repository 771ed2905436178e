from .executor import CutJob, CutQueue, execute_cut, quantized_segments

__all__ = ["CutJob", "CutQueue", "execute_cut", "quantized_segments"]
