"""glom-lint over the port: static analysis for the framework's own hazards.

The port's copy of `glom_tpu/analysis/`. `python -m glom_tpu_torch.analysis
[PATHS] [--baseline FILE]` runs the four checkers that read no framework's
constructs, grounded in invariants the package otherwise keeps by
convention:

    schema-emit          emit/stamp sites use registered kinds;
                         UNMEASURED is null, never 0.0
    lockset              threaded-class shared attributes stay behind
                         their lock
    lock-order           no two locks taken in both nestings (a cycle,
                         also across classes and modules, is a deadlock)
    signal-safety        nothing reachable from a signal handler takes a
                         plain Lock or blocks

glom_tpu's other four (collective-coverage, axis-environment, trace-purity,
donation-safety) read jax's collectives, traced bodies and donated buffers;
their torch forms are ROADMAP item A10b, and selecting one by name raises.

Pure stdlib: the pass reads source only. `chip_smoke.py` runs it first,
before the card is touched, so a run never starts on code with a known
lock or schema violation.
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
