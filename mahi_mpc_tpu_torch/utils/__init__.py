from .profiling import annotate, device_trace
from .results import ControlLog

__all__ = ["ControlLog", "annotate", "device_trace"]
