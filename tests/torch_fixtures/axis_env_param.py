"""Torch twin of tests/fixtures/axis_env_param.py, line for line, for the
port's axis-environment caller attestation (analysis/axisenv.py).

The blind spot this pair pins: `_serve_shard_leaky` takes its mesh as an
opaque PARAMETER, and this module ALSO builds a 'model'-carrying
training mesh — so the module-wide MeshConfig union ({data, seq, model})
would attest the wrong environment and miss the bug. The checker must
instead follow the intra-module CALLER (`build_serve_leaky`) to its
`MeshConfig(data=..., seq=...)` and flag the all-reduce over axes.model,
both at the direct site and through the registered wrapper's threaded
Axis. `_serve_shard_clean` is the twin with every collective on a
caller-attested axis. `_opaque_shard` has NO intra-module caller at all
— with the module union in play it attests {data, seq, model} and stays
clean (the fallback contract, unchanged).

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


def build_train_mesh():
    """The 'model'-carrying training mesh that poisons the module-wide
    union — the reason caller attestation must win over the fallback."""
    return make_mesh(MeshConfig(data=2, seq=2, model=2))


def _psum_wire(x, axis, k):
    """The registered-wrapper idiom the real serve mesh uses."""
    from glom_tpu_torch.parallel.collectives import all_reduce

    tele_counters.record_collective("reduce", 0 * k)
    return all_reduce(x, axis)


def _serve_shard_leaky(mesh):
    from glom_tpu_torch.parallel.collectives import all_reduce

    def body(x, y):
        part = _psum_wire(x, axes.seq, 2)  # fine: caller mesh has 'seq'
        # BUG: the module builds a 'model' mesh SOMEWHERE (build_train_
        # mesh), but THIS body's callers only ever pass (data, seq).
        tele_counters.record_collective("reduce", 0)
        bad = all_reduce(part, axes.model)
        return _psum_wire(bad + y, axes.model, 2)  # threaded: also bad

    axes = rank_axes(mesh)
    return axes_stand_in(
        body,
        axes.data,
        axes.seq,
    )


def build_serve_leaky():
    mesh = make_mesh(MeshConfig(data=4, seq=2))
    return _serve_shard_leaky(mesh)


def _serve_shard_clean(mesh):
    def body(x, y):
        part = _psum_wire(x, axes.seq, 2)
        return _psum_wire(part + y, axes.data, 4)

    axes = rank_axes(mesh)
    return axes_stand_in(
        body,
        axes.data,
        axes.seq,
    )


def build_serve_clean():
    mesh = make_mesh(MeshConfig(data=4, seq=2))
    return _serve_shard_clean(mesh)


def _hop_leaky(mesh):
    """Leaky THROUGH a forwarding hop: the only path to a MeshConfig is
    caller -> caller (bounded parameter-to-parameter recursion). Flagged
    only when the checker actually follows the second hop."""
    from glom_tpu_torch.parallel.collectives import all_reduce, mesh_axis

    def body(x):
        tele_counters.record_collective("reduce", 0)
        return all_reduce(x, mesh_axis(mesh, MODEL_AXIS))

    return axes_stand_in(body, mesh)


def _forward_mesh(mesh):
    return _hop_leaky(mesh)


def build_serve_forwarded():
    mesh = make_mesh(MeshConfig(data=4, seq=2))
    return _forward_mesh(mesh)


def _opaque_shard(mesh):
    """No intra-module caller: falls back to the module union (which
    includes 'model' via build_train_mesh) — stays clean, the unchanged
    fallback contract."""
    from glom_tpu_torch.parallel.collectives import all_reduce, mesh_axis

    def body(x):
        tele_counters.record_collective("reduce", 0)
        return all_reduce(x, mesh_axis(mesh, MODEL_AXIS))

    return axes_stand_in(body, mesh)
