from .results import ControlLog

__all__ = ["ControlLog"]
