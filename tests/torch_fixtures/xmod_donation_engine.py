"""Torch twin of tests/fixtures/xmod_donation_engine.py, line for line:
the companion provider module of tests/torch_fixtures/xmod_donation.py.

`Engine` exposes a provider method that returns an UNPINNED pool snapshot
(a bare `pool.buffer()`) — the shape that taints its callers. Nothing in
THIS module dispatches the snapshot; the hazard only exists at the
consumer, one import away.

LINT FIXTURE: parsed, never imported.
"""

import torch


class Engine:
    def __init__(self, pool):
        self.pool = pool

    def snapshot(self):
        """Provider: returns a bare buffer() snapshot (the taint must
        survive the return into a typed caller)."""
        return self.pool.buffer()

    def pinned(self):
        """A pinned buffer: the caller pairs it with release_read()."""
        return self.pool.acquire_read()

    def forward(self, params, *tensors):
        return torch.stack([params, *tensors])
