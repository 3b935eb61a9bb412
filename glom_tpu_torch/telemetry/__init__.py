"""Telemetry: the on-device training diagnostics (the per-level agreement
included), the versioned JSONL event schema, the request trace context,
the step-time histograms and the stamped bench emitter, the collective
counters and their wall time (`counters.py`, `comm_time.py`), the backend
watchdog, the elastic fleet's evidence (the load forecast, the decision
audit and the pod aggregation with its live SLO monitor), and the
operator's readers: the bench-trajectory regression gate (`compare.py`)
and the Perfetto export (`perfetto.py`). These are the port's copies of
glom_tpu's `telemetry/` modules, one file each under the same name.

`python -m glom_tpu_torch.telemetry FILE...` lints a log against the
schema (`... compare BASE NEW` gates a bench trajectory, `... perfetto
FILE... -o OUT` writes a trace, `... trace FILE...` rebuilds one request's
tree, `... audit FILE...` replays the elastic decision chain, `...
aggregate PATH...` and `... watch DIR --slo R=T` roll up and watch
streams).

Re-exports are lazy (PEP 562, as glom_tpu's): `schema`, `compare` and
`perfetto` themselves import only the standard library, and a reader of
one does not load the others.
"""

_EXPORTS = {
    "CollectiveCounters": "counters",
    "comm_drift": "counters",
    "record_collective": "counters",
    "recording": "counters",
    "TELEMETRY_LEVELS": "diagnostics",
    "resolve_telemetry_level": "diagnostics",
    "SCHEMA_VERSION": "schema",
    "stamp": "schema",
    "validate_record": "schema",
    "StepTimeStats": "sinks",
    "emit": "sinks",
    "BackendWatchdog": "watchdog",
    "backend_record": "watchdog",
    "get_global_watchdog": "watchdog",
    "set_global_watchdog": "watchdog",
}
_SUBMODULES = (
    "compare", "counters", "diagnostics", "perfetto", "schema", "sinks",
    "watchdog",
)

__all__ = sorted([*_EXPORTS, *_SUBMODULES])


def __getattr__(name):
    import importlib

    if name in _SUBMODULES:
        return importlib.import_module(f"glom_tpu_torch.telemetry.{name}")
    if name in _EXPORTS:
        module = importlib.import_module(f"glom_tpu_torch.telemetry.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module 'glom_tpu_torch.telemetry' has no attribute {name!r}")
