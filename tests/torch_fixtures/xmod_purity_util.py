"""Torch twin of tests/fixtures/xmod_purity_util.py, line for line: the
companion of tests/torch_fixtures/xmod_purity.py.

The helpers here are imported into another module's compiled body — the
host side effect in `log_levels` is only a bug BECAUSE of that import,
which is exactly the reachability hop the single-module checker could
not see. This file on its own is clean (nothing here traces anything).

LINT FIXTURE: parsed, never imported.
"""


def log_levels(x):
    """Host print on its argument — harmless at module scope, a silent
    capture-time print (or a graph break) inside a compiled body."""
    print("levels", x)
    return x


def scale(x, k):
    """Pure twin: safe to reach from any traced entry."""
    return x * k
