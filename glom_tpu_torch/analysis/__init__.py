"""glom-lint over the port: static analysis for the framework's own hazards.

The port's copy of `glom_tpu/analysis/`. `python -m glom_tpu_torch.analysis
[PATHS] [--baseline FILE]` runs glom_tpu's eight checkers, in its order,
grounded in invariants the package otherwise keeps by convention:

    collective-coverage  manual-path collectives name declared mesh axes
                         and are registered with telemetry.counters
    axis-environment     a collective's axis exists in the mesh its Axis
                         comes from (not just in the global vocabulary)
    trace-purity         no host side effects inside torch.compile /
                         CUDA-graph / torch.func regions
    donation-safety      no dispatch reads the page pool through an
                         unpinned buffer() snapshot
    schema-emit          emit/stamp sites use registered kinds;
                         UNMEASURED is null, never 0.0
    lockset              threaded-class shared attributes stay behind
                         their lock
    lock-order           no two locks taken in both nestings (a cycle,
                         also across classes and modules, is a deadlock)
    signal-safety        nothing reachable from a signal handler takes a
                         plain Lock or blocks

The first four are the torch forms of glom_tpu's jax-reading checkers:
each module's docstring says what carried over and what has no torch
counterpart.

Pure stdlib: the pass reads source only. `chip_smoke.py` runs it first,
before the card is touched, so a run never starts on code with a known
lock, schema or collective violation.
"""

from glom_tpu_torch.analysis.core import (
    Checker,
    Context,
    Finding,
    SourceModule,
    default_checkers,
    run,
)

__all__ = [
    "Checker",
    "Context",
    "Finding",
    "SourceModule",
    "default_checkers",
    "run",
]
