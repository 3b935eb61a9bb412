"""Torch twin of tests/fixtures/xmod_mesh_flow_runtime.py, line for line:
the companion caller module of tests/torch_fixtures/xmod_mesh_flow.py.

This module is where every mesh is BUILT; the collectives it feeds live
one import away. `serve` builds a (data, seq)-intent serve mesh — the
leaky builder's only caller. `train` forwards a MeshConfig-ANNOTATED
parameter through the factory, which attests the full axis tuple
(MeshConfig.axis_names is unconditionally all three) for the
train-shaped builder.

LINT FIXTURE: parsed, never imported.
"""

from xmod_mesh_flow import build_clean, build_leaky, build_train


class MeshConfig:
    """Stand-in for glom_tpu_torch.utils.config.MeshConfig: the checker
    matches the NAME for ctor-keyword intent, and the annotation rule
    needs the class defined in an ANALYZED module — this keeps the pair
    self-contained (lint runs over just these two files)."""

    def __init__(self, data=1, seq=1, model=1):
        self.data, self.seq, self.model = data, seq, model


def make_mesh(cfg: MeshConfig):
    return cfg, "cpu"


def serve():
    mesh, _ = make_mesh(MeshConfig(data=2, seq=2))
    return build_leaky(mesh), build_clean(mesh)


def train(mesh_cfg: MeshConfig):
    mesh, _ = make_mesh(mesh_cfg)
    return build_train(mesh)
