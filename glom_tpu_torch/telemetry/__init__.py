"""Telemetry: the on-device training diagnostics, the versioned JSONL
event schema, the request trace context, the step-time histograms and the
backend-state seam (the port's copies of glom_tpu's `diagnostics.py` in
part, `schema.py`, `tracectx.py`, `sinks.py`'s StepTimeStats and
`watchdog.py`'s global registration and `backend_record`).

`python -m glom_tpu_torch.telemetry FILE...` lints a log against the
schema (`... trace FILE...` rebuilds one request's tree).
"""
