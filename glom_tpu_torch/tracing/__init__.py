"""Tracing: host-side software spans, the crash flight recorder and the
perf report (the port's copies of glom_tpu's `tracing/spans.py`,
`flight.py` and `report.py`).

    spans   -- span() context manager + per-phase aggregation, emitting
               versioned "span" JSONL events
    flight  -- bounded ring of the last N telemetry events, dumped to
               flight_<ts>.jsonl on an anomaly storm, SIGTERM/exit, or an
               unhandled fit_loop exception
    report  -- the MFU perf report and the rolling StepTimer

glom_tpu's programmatic capture (`capture.py`) and device-memory
accounting (`memory.py`) are ROADMAP queue A item 9.
"""

from glom_tpu_torch.tracing.flight import (
    FlightRecorder,
    dump_flight_recorder,
    get_global_flight_recorder,
    observe_event,
    set_global_flight_recorder,
    write_or_observe,
)
from glom_tpu_torch.tracing.report import StepTimer, perf_report
from glom_tpu_torch.tracing.spans import PHASES, SpanAggregator, span, spanned

__all__ = [
    "PHASES",
    "FlightRecorder",
    "SpanAggregator",
    "StepTimer",
    "dump_flight_recorder",
    "get_global_flight_recorder",
    "observe_event",
    "perf_report",
    "set_global_flight_recorder",
    "span",
    "spanned",
    "write_or_observe",
]
