"""Telemetry: the on-device training diagnostics, the versioned JSONL
event schema, the request trace context, the step-time histograms, the
backend-state seam, and the elastic fleet's evidence: the load forecast,
the decision audit and the pod aggregation with its live SLO monitor (the
port's copies of glom_tpu's `diagnostics.py` in part, `schema.py`,
`tracectx.py`, `sinks.py`'s StepTimeStats, `watchdog.py`'s global
registration and `backend_record`, `forecast.py`, `audit.py` and
`aggregate.py`).

`python -m glom_tpu_torch.telemetry FILE...` lints a log against the
schema (`... trace FILE...` rebuilds one request's tree, `... audit
FILE...` replays the elastic decision chain, `... aggregate PATH...` and
`... watch DIR --slo R=T` roll up and watch streams).
"""
