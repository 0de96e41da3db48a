from .batch_service import BatchModelControl

__all__ = ["BatchModelControl"]
