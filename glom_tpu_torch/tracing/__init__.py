"""Tracing: host-side software spans, the crash flight recorder, the perf
report, profiler capture and device-memory accounting (the port's copies
of glom_tpu's `tracing/spans.py`, `flight.py`, `report.py`, `capture.py`
and `memory.py`).

    spans   -- span() context manager + per-phase aggregation, emitting
               versioned "span" JSONL events
    flight  -- bounded ring of the last N telemetry events, dumped to
               flight_<ts>.jsonl on an anomaly storm, SIGTERM/exit, or an
               unhandled fit_loop exception
    report  -- the MFU perf report and the rolling StepTimer
    capture -- step-windowed and whole-run torch.profiler traces
               (TraceCapture, trace), exported as Chrome traces
    memory  -- the CUDA allocator's watermarks against the live-bytes model
    nvtx    -- NVTX ranges, glom_tpu's named scopes on the card's timeline
"""

from glom_tpu_torch.tracing.capture import TraceCapture, annotate, start_server, trace
from glom_tpu_torch.tracing.flight import (
    FlightRecorder,
    dump_flight_recorder,
    get_global_flight_recorder,
    observe_event,
    set_global_flight_recorder,
    write_or_observe,
)
from glom_tpu_torch.tracing.memory import hbm_watermarks, memory_record
from glom_tpu_torch.tracing.report import StepTimer, perf_report
from glom_tpu_torch.tracing.spans import PHASES, SpanAggregator, span, spanned

__all__ = [
    "PHASES",
    "FlightRecorder",
    "SpanAggregator",
    "StepTimer",
    "TraceCapture",
    "annotate",
    "dump_flight_recorder",
    "get_global_flight_recorder",
    "hbm_watermarks",
    "memory_record",
    "observe_event",
    "perf_report",
    "set_global_flight_recorder",
    "span",
    "spanned",
    "start_server",
    "trace",
    "write_or_observe",
]
