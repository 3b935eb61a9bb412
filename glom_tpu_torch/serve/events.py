"""The one serve-record emitter: stamp the kind, merge the backend state,
route the record.

The port's copy of `glom_tpu/serve/events.py`. Every serving sink (the
engine's warmups, bucket stats and release, the page pool's alloc, free,
alias and defrag events) stamps its records with the schema kind, the
current backend state (keys already present win) and, inside a dispatch
scope, the dispatch's trace context, and delivers them to the writer when
one is attached, else to the global flight recorder.
"""

from __future__ import annotations

from glom_tpu_torch.telemetry import schema


def stamp_serve(rec: dict, kind: str = "serve") -> dict:
    """A stamped copy of `rec` carrying the kind, the watchdog's backend
    state and (inside a dispatch scope) the dispatch's trace context.
    Keys already present always win; a record that carries its own trace
    identity is never widened to the whole batch scope."""
    from glom_tpu_torch.telemetry import tracectx
    from glom_tpu_torch.telemetry.watchdog import backend_record

    stamped = schema.stamp(rec, kind=kind)
    for k, v in backend_record().items():
        stamped.setdefault(k, v)
    if not any(k in stamped for k in ("trace_id", "trace_ids")):
        stamped.update(tracectx.current_fields())
    return stamped


def emit_serve(writer, rec: dict, kind: str = "serve") -> dict:
    """stamp_serve, then writer-else-flight delivery; returns the stamped
    record."""
    from glom_tpu_torch.tracing.flight import write_or_observe

    stamped = stamp_serve(rec, kind=kind)
    write_or_observe(writer, stamped)
    return stamped
