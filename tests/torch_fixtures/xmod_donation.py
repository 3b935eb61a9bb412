"""Torch twin of tests/fixtures/xmod_donation.py, line for line, for the
port's donation-safety CROSS-MODULE flow (analysis/donation.py +
analysis/project.py).

The blind spot this pair pins: the provider of an unpinned pool snapshot
lives on `Engine` in xmod_donation_engine.py, but the snapshot is
DISPATCHED here, through a typed receiver (`eng: Engine`). A single-module
pass has no idea `eng.snapshot()` returns a bare `buffer()`. The
whole-program pass must:

  * flag `serve_leaky`'s dispatch of the provider's snapshot;
  * flag `provider_leaky` the same way behind a metadata read (which
    is not itself a dispatch: the subscript after it is);
  * flag `splat_leaky`'s dispatch of the snapshot after a `*`-splat;
  * leave the clean twins green (a pinned buffer dispatched / only the
    snapshot's metadata read: its dtype, never its pages — a read that
    an in-place write-back cannot tear).

LINT FIXTURE: parsed, never imported (lint both files together).
"""

from xmod_donation_engine import Engine


def serve_leaky(eng: Engine, params, idx):
    buf = eng.snapshot()
    return eng.forward(params, buf), idx  # BUG: dispatched unpinned


def serve_clean(eng: Engine, params, idx):
    buf = eng.pinned()
    return eng.forward(params, buf), idx  # pinned by acquire_read()


def provider_leaky(eng: Engine, params, idx):
    buf = eng.snapshot()
    rows = buf.shape[0]
    return eng.forward(params, buf[idx % rows])  # BUG: unpinned rows


def provider_clean(eng: Engine, params, idx):
    buf = eng.snapshot()
    return eng.forward(params, idx), buf.dtype


def splat_leaky(eng: Engine, args):
    buf = eng.snapshot()
    return eng.forward(*args, buf)  # BUG: dispatched unpinned
