"""The profiling names of `glom_tpu/utils/profiling.py`, re-exported from
the port's `tracing/` package, where they live:

    trace / start_server / annotate  -> glom_tpu_torch.tracing.capture
    perf_report / StepTimer          -> glom_tpu_torch.tracing.report
"""

from glom_tpu_torch.tracing.capture import annotate, start_server, trace
from glom_tpu_torch.tracing.report import StepTimer, perf_report

__all__ = ["StepTimer", "annotate", "perf_report", "start_server", "trace"]
