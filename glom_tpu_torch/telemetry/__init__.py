"""On-device training diagnostics (the part of glom_tpu's telemetry the
train step calls)."""
