"""Partition specs: how params, optimizer state and batches lay out over
the rank mesh.

Counterpart of `glom_tpu/parallel/sharding.py`, with its names and rules.
glom_tpu's PartitionSpec trees become plain Python: a spec is a tuple
with one entry per dimension, the mesh axis that splits it or None, and a
spec tree is a dict keyed by the leaf's dotted name (`named_leaves`
order: "token_embed.w", ..., "bottom_up.w1", ... for GlomParams; the
trainer's DenoiseParams put "glom." before those and end with
"to_pixels.w", "to_pixels.b").
`shard_leaf` slices a rank's shard of a leaf by its spec.

Tensor parallelism (TP) shards the grouped-FFW HIDDEN axis, Megatron
style: w1 [G, d, f] and b1 [G, f] split f over 'model'; w2 [G, f, d]
splits its f contraction axis, and the second product's output is summed
over 'model' (parallel/manual.py). Embeddings and init_levels replicate.
`tp_axis="levels"` (the EP-style split of the group axis) is glom_tpu's
spec and is kept here as data; the port's runtime refuses it (ROADMAP
queue A item 8b).

glom_tpu's `to_named` (PartitionSpec -> NamedSharding) has no
counterpart: there is no GSPMD here. Each rank holds its shards as plain
tensors, and every collective is an explicit call.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from glom_tpu_torch.ops.ffw import GroupedFFWParams

Spec = Tuple[Optional[str], ...]


def ffw_specs(tp_axis: str = "hidden") -> GroupedFFWParams:
    if tp_axis == "hidden":
        return GroupedFFWParams(w1=(None, None, "model"), b1=(None, "model"),
                                w2=(None, "model", None), b2=(None, None))
    if tp_axis == "levels":  # EP-style: shard the independent level groups
        return GroupedFFWParams(w1=("model", None, None), b1=("model", None),
                                w2=("model", None, None), b2=("model", None))
    raise ValueError(f"tp_axis must be 'hidden' or 'levels', got {tp_axis!r}")


def glom_param_specs(tp_axis: str = "hidden") -> Dict[str, Spec]:
    # In 'levels' mode only bottom_up (G = L) shards its group axis; top_down
    # has G = L - 1, coprime with L, so it shards its hidden axis instead.
    td_axis = "hidden" if tp_axis == "levels" else tp_axis
    specs = {"token_embed.w": (None, None), "token_embed.b": (None,),
             "pos_emb": (None, None), "init_levels": (None, None)}
    for which, axis in (("bottom_up", tp_axis), ("top_down", td_axis)):
        for key, spec in ffw_specs(axis)._asdict().items():
            specs[f"{which}.{key}"] = spec
    return specs


def denoise_param_specs(tp_axis: str = "hidden") -> Dict[str, Spec]:
    """The trainer's leaves: the GLOM params under "glom." and the head."""
    return {**{f"glom.{k}": v for k, v in glom_param_specs(tp_axis).items()},
            "to_pixels.w": (None, None), "to_pixels.b": (None,)}


def batch_spec() -> Spec:
    """[b, c, H, W] image batches shard on the data axis."""
    return ("data", None, None, None)


def levels_spec() -> Spec:
    """[b, n, L, d] column state: batch on 'data', patch axis on 'seq'."""
    return ("data", "seq", None, None)


def _entries(spec: Spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def zero_shard_axis(shape, base_spec: Spec, dp: int) -> Optional[int]:
    """The axis a ZeRO update shards over 'data' for one param-shaped leaf:
    the LARGEST free axis (not taken by the base TP spec) whose global dim
    divides by dp; None when no axis qualifies (that leaf's optimizer
    state stays replicated)."""
    if dp <= 1:
        return None
    entries = _entries(base_spec, len(shape))
    best = None
    for ax, dim in enumerate(shape):
        if entries[ax] is None and dim % dp == 0 and (best is None or dim > shape[best]):
            best = ax
    return best


def zero_param_specs(params, dp: int, tp_axis: str = "hidden") -> Dict[str, Spec]:
    """The ZeRO layout: the base TP spec with 'data' added on each leaf's
    zero_shard_axis. `params` is a DenoiseParams (or any structure
    `named_leaves` walks) with the global shapes."""
    from glom_tpu_torch.utils.checkpoint import named_leaves

    base = denoise_param_specs(tp_axis)
    out = {}
    for name, t in named_leaves(params):
        entries = _entries(base[name], t.dim())
        ax = zero_shard_axis(tuple(t.shape), base[name], dp)
        if ax is not None:
            entries[ax] = "data"
        out[name] = tuple(entries)
    return out


def opt_state_specs(param_specs: Dict[str, Spec]) -> Dict[str, dict]:
    """Adam's per-parameter state: the moments follow the param layout,
    the step counter replicates."""
    return {name: {"exp_avg": s, "exp_avg_sq": s, "step": ()} for name, s in param_specs.items()}


def spec_axis(spec: Spec, axis: str) -> int:
    """The dimension `axis` splits in `spec`, or -1."""
    return spec.index(axis) if axis in spec else -1


def shard_leaf(t: torch.Tensor, spec: Spec, coords: Dict[str, Tuple[int, int]]) -> torch.Tensor:
    """This rank's shard of a global leaf: for each dimension its spec
    splits, the `index`-th of `size` equal slices, from coords {axis:
    (index, size)}. A view; the caller copies if it must own it."""
    for ax, name in enumerate(spec):
        if name is None:
            continue
        index, size = coords[name]
        if t.shape[ax] % size:
            raise ValueError(f"dim {ax} of {tuple(t.shape)} does not split {size} ways")
        step = t.shape[ax] // size
        t = t.narrow(ax, index * step, step)
    return t
