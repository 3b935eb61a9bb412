"""Torch twin of tests/fixtures/collective_timing.py, line for line, for
the port's collective-coverage hand-rolled-timing rule
(glom_tpu_torch/analysis/collectives.py).

`leaky_timed_reduce` registers its all-reduce's wire bytes (the
registration contract holds) but brackets the collective with its OWN
pair of CUDA events — exactly the hand-rolled timing the shared wrapper
exists to replace: a private clock discipline and a record shape the
schema never sees. `clean_timed_reduce` is the twin routed through
`counters.timed_collective` — the ONE sanctioned timing route (byte
recording + site registry + the full-mode event brackets).

This file is a LINT FIXTURE: the test copies its source under a
registration-scope path (parallel/manual.py) and asserts exactly one
hand-rolled-timing finding at the leaky all-reduce. Parsed, never
imported.
"""

import torch

from glom_tpu_torch.parallel.collectives import all_reduce
from glom_tpu_torch.telemetry import counters as tele_counters

DATA_AXIS = "data"


def recorded_event():  # pragma: no cover — stand-in, parsed not executed
    """A CUDA event recorded on the current stream: the hand-rolled
    harness's clock. The shared wrapper brackets a collective with such
    a pair itself (counters.timed_collective under timing('full', log)),
    so a site that records its own pair keeps a second clock discipline
    and a record shape the schema never sees."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def leaky_timed_reduce(g, k, data_axis):
    """FLAGGED: record_collective registers the bytes, but the timing is
    a hand-rolled pair of CUDA events around the collective."""
    tele_counters.record_collective(
        "reduce", tele_counters.ring_allreduce_bytes(g, k)
    )
    start = recorded_event()
    out = all_reduce(g, data_axis)
    elapsed_ms = start.elapsed_time(recorded_event())
    return out, elapsed_ms


def clean_timed_reduce(g, k, data_axis):
    """CLEAN: the shared wrapper owns the bytes, the site registry, and
    (under timing('full', log)) the event brackets."""
    return tele_counters.timed_collective(
        "fixture_psum", DATA_AXIS, "reduce",
        tele_counters.ring_allreduce_bytes(g, k),
        lambda x: all_reduce(x, data_axis), g, collective="psum",
    )
