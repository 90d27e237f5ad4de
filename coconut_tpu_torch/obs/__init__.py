"""Observability of the port's host layers — a copy of `coconut_tpu/obs/`
with the same span names and file formats: request-scoped tracing, trace
export, and the fault flight recorder.

  trace.py   Span/Tracer — contextvar propagation, injectable clock,
             bounded ring buffer, zero-cost no-op path when disabled
             (COCONUT_TRACE=0, the default)
  export.py  JSONL span records + Chrome-trace/Perfetto JSON
  flight.py  on dead-letter / checkpoint quarantine, dump the failing
             request's span tree + the recent-span tail to a JSONL next
             to the triggering artifact

metrics.py stays the aggregate surface (counters/timers/histograms);
this package is the per-request one (span taxonomy in trace.py).
"""

from . import export, flight, trace  # noqa: F401
from .trace import (  # noqa: F401
    NOOP,
    Span,
    Tracer,
    current,
    disable,
    enable,
    enabled,
    end_span,
    event,
    get_tracer,
    span,
    start_span,
    use,
)

__all__ = [
    "trace",
    "export",
    "flight",
    "Span",
    "Tracer",
    "NOOP",
    "enable",
    "disable",
    "enabled",
    "get_tracer",
    "span",
    "start_span",
    "use",
    "current",
    "event",
    "end_span",
]
