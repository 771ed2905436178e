from .batch import BatchProcessor, StreamResult, list_videos

__all__ = ["BatchProcessor", "StreamResult", "list_videos"]
