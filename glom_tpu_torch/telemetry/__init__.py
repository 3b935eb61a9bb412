"""Telemetry: the on-device training diagnostics (the per-level agreement
included), the versioned JSONL event schema, the request trace context,
the step-time histograms, the collective counters and their wall time
(`counters.py`, `comm_time.py`), the backend watchdog, and the elastic
fleet's evidence: the load forecast, the decision audit and the pod
aggregation with its live SLO monitor (the port's copies of glom_tpu's
`diagnostics.py`, `schema.py`, `tracectx.py`, `sinks.py`'s StepTimeStats,
`counters.py`, `comm_time.py`, `watchdog.py`, `forecast.py`, `audit.py`
and `aggregate.py`).

`python -m glom_tpu_torch.telemetry FILE...` lints a log against the
schema (`... trace FILE...` rebuilds one request's tree, `... audit
FILE...` replays the elastic decision chain, `... aggregate PATH...` and
`... watch DIR --slo R=T` roll up and watch streams).
"""
