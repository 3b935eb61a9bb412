"""Torch twin of tests/fixtures/axis_env.py, line for line, for the port's
axis-environment checker (glom_tpu_torch/analysis/axisenv.py).

`leaky_serve_body` all-reduces over axes.model on a rank whose mesh is
('data', 'seq') — a vocabulary-LEGAL axis (the training mesh declares it)
that this mesh never sizes, so the Axis has size 1 and the all-reduce
silently issues nothing: the copied-from-training bug the checker exists
to catch on the CPU. `clean_serve_body` is the twin with every collective
on a sized axis, including one threaded through the registered wrapper.

This file is a LINT FIXTURE: it is parsed, never imported (the stand-ins
below keep it import-safe anyway).
"""

from glom_tpu_torch.telemetry import counters as tele_counters
from glom_tpu_torch.utils.config import MeshConfig

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


def rank_axes(mesh):  # stand-in: parallel/manual.rank_axes
    return mesh


def axes_stand_in(*axes):  # noqa: ARG001 — parsed, not executed
    return axes


def make_mesh(cfg):
    return cfg


def all_reduce_stand_in(x, axis):  # pragma: no cover — never called
    del axis
    return x


def _psum_wire(x, axis, k):
    """The registered-wrapper idiom the real serve mesh uses."""
    from glom_tpu_torch.parallel.collectives import all_reduce

    tele_counters.record_collective("reduce", 0 * k)
    return all_reduce(x, axis)


def build_leaky():
    from glom_tpu_torch.parallel.collectives import all_reduce

    mesh = make_mesh(MeshConfig(data=4, seq=2))
    axes = rank_axes(mesh)

    def leaky_serve_body(x, y):
        tele_counters.record_collective("reduce", 0)
        part = all_reduce(x, axes.seq)  # fine: 'seq' is in the mesh
        # BUG: 'model' is a declared axis SOMEWHERE (the training mesh),
        # but THIS rank's ('data', 'seq') mesh never sizes it.
        tele_counters.record_collective("reduce", 0)
        bad = all_reduce(part, axes.model)
        return _psum_wire(bad + y, axes.model, 2)  # threaded: also bad

    return axes_stand_in(
        leaky_serve_body,
        mesh,
        axes.data,
        axes.seq,
    )


def build_clean():
    from glom_tpu_torch.parallel.collectives import all_reduce

    mesh = make_mesh(MeshConfig(data=4, seq=2))
    axes = rank_axes(mesh)

    def clean_serve_body(x, y):
        tele_counters.record_collective("reduce", 0)
        part = all_reduce(x, axes.seq)
        total = _psum_wire(part + y, axes.data, 4)  # threaded: sized
        return total

    return axes_stand_in(
        clean_serve_body,
        mesh,
        axes.data,
        axes.seq,
    )
