"""Torch twin of tests/fixtures/xmod_purity.py, line for line, for the
port's trace-purity CROSS-MODULE reach (analysis/purity.py).

The blind spot this pair pins: `step_leaky` is compiled HERE, but the
host `print` it reaches lives in xmod_purity_util.py — a single-module
reachability walk ends at the import boundary and misses it. The
whole-program walk must follow the imported call and flag the print AT
ITS OWN file:line in the util module. `step_clean` reaches only the
pure twin and stays green.

LINT FIXTURE: parsed, never imported (lint both files together:
run([xmod_purity.py, xmod_purity_util.py])).
"""

import torch

from xmod_purity_util import log_levels, scale


def step_leaky(x):
    # BUG (flagged in xmod_purity_util.py, at the print): the imported
    # helper host-prints its argument, a traced tensor here.
    return log_levels(x) * 2


def step_clean(x):
    return scale(x, 2)


fast_leaky = torch.compile(step_leaky)
fast_clean = torch.compile(step_clean)
