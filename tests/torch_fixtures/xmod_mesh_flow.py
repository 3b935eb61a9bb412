"""Torch twin of tests/fixtures/xmod_mesh_flow.py, line for line: the
port's axis-environment CROSS-MODULE mesh flow (analysis/axisenv.py).

The blind spot this pair pins: this module builds NO mesh — every
builder takes it as an opaque parameter, and the MeshConfig evidence
lives in xmod_mesh_flow_runtime.py, one import away. A single-module
pass has an empty module union and must SKIP all three sites; the
whole-program pass follows the cross-module caller:

  * `build_leaky`'s only caller passes a MeshConfig(data, seq) serve
    mesh — its body's all-reduce over axes.model is flagged HERE,
    through the import boundary;
  * `build_clean` runs the same flow on a sized axis: green;
  * `build_train`'s mesh traces back to a MeshConfig-ANNOTATED
    parameter (the trainer/runtime shape), which attests the full
    {data, seq, model} tuple — its 'model' all-reduce is legal: green.

LINT FIXTURE: parsed, never imported (lint both files together).
"""

from glom_tpu_torch.parallel.collectives import all_reduce

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"


def rank_axes(mesh):  # stand-in: parallel/manual.rank_axes
    return mesh


def axes_stand_in(*axes):  # noqa: ARG001 — parsed, not executed
    return axes


def build_leaky(mesh):
    def body(x):
        # BUG: the only caller ever passes a (data, seq) serve mesh —
        # this axis is sized nowhere in this body's environment.
        return all_reduce(x, axes.model)

    axes = rank_axes(mesh)
    return axes_stand_in(
        body, axes.data, axes.seq)


def build_clean(mesh):
    def body(x):
        return all_reduce(x, axes.seq)

    axes = rank_axes(mesh)
    return axes_stand_in(
        body, axes.data, axes.seq)


def build_train(mesh):
    def body(x):
        return all_reduce(x, axes.model)  # legal: annotated-config mesh

    axes = rank_axes(mesh)
    return axes_stand_in(
        body, axes.data, axes.seq)
