from .profiling import (Span, annotate, clear_spans, device_trace, spans,
                        spans_dropped)
from .results import ControlLog

__all__ = ["ControlLog", "Span", "annotate", "clear_spans", "device_trace",
           "spans", "spans_dropped"]
