"""The process-global backend watchdog seam and the backend-state fields.

The port's copy of `set_global_watchdog`, `get_global_watchdog` and
`backend_record` from `glom_tpu/telemetry/watchdog.py`. A registered
watchdog (anything with a `record()` returning the `backend_state`,
`backend_devices` and `backend_transitions` fields) lets every sink stamp
the current backend state without threading a handle through each call,
and lets the dispatch retry policy fail fast on a backend that is down
(resilience/retry.py). Without one, the state is "up" once this process
has initialised CUDA and "unknown" before: never a guess. glom_tpu's
`BackendWatchdog` thread and its probe come with ROADMAP queue A item 9.
"""

from __future__ import annotations

import torch

_GLOBAL = None


def set_global_watchdog(wd) -> None:
    global _GLOBAL
    _GLOBAL = wd


def get_global_watchdog():
    return _GLOBAL


def _inprocess_backend_live() -> bool:
    """Has this process already initialised CUDA? A live in-process
    context is the one case where "up" is certain without a probe."""
    return torch.cuda.is_initialized()


def backend_record() -> dict:
    """Watchdog fields for a record: the global watchdog's state when one
    is registered; otherwise "up" iff CUDA is live in this process, else
    "unknown"."""
    wd = get_global_watchdog()
    if wd is not None:
        return wd.record()
    return {"backend_state": "up" if _inprocess_backend_live() else "unknown"}
