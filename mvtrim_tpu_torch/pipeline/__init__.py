from .pipeline import ProcessingPipeline, ScanResult

__all__ = ["ProcessingPipeline", "ScanResult"]
