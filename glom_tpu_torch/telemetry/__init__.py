"""Telemetry: the on-device training diagnostics, the versioned JSONL
event schema, the request trace context and the step-time histograms
(the port's copies of glom_tpu's `diagnostics.py` in part, `schema.py`,
`tracectx.py` and `sinks.py`'s StepTimeStats).

`python -m glom_tpu_torch.telemetry FILE...` lints a log against the
schema (`... trace FILE...` rebuilds one request's tree).
"""
