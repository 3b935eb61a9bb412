"""Carry glom_tpu's parameters into the port.

`params_from_numpy` takes glom_tpu's `GlomParams` leaves as numpy arrays,
keyed by their dotted paths, and builds the port's `GlomParams` on
`device`; with the reconstruction head's `to_pixels.w` and `to_pixels.b`
as well, it builds the trainer's `DenoiseParams`. Both packages keep weights in the same orientation (`w` is
[in, out], grouped `w1` is [G, d, f], `w2` is [G, f, d]), so nothing is
transposed.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from glom_tpu_torch.models.core import GlomParams
from glom_tpu_torch.ops.ffw import GroupedFFWParams
from glom_tpu_torch.ops.patch import LinearParams

FFW_KEYS = ("w1", "b1", "w2", "b2")
PARAM_KEYS = (
    "token_embed.w", "token_embed.b", "pos_emb", "init_levels",
    *(f"bottom_up.{k}" for k in FFW_KEYS),
    *(f"top_down.{k}" for k in FFW_KEYS),
)
HEAD_KEYS = ("to_pixels.w", "to_pixels.b")


def params_from_numpy(arrays: Mapping[str, np.ndarray], device="cpu"):
    """{dotted path: array} -> the port's GlomParams on `device`, or its
    DenoiseParams when the to_pixels keys are there too."""
    keys = PARAM_KEYS + (HEAD_KEYS if any(k in arrays for k in HEAD_KEYS) else ())
    missing = set(keys) - set(arrays)
    extra = set(arrays) - set(keys)
    if missing or extra:
        raise KeyError(f"missing {sorted(missing)}, unexpected {sorted(extra)}")

    def t(key):
        return torch.from_numpy(np.array(arrays[key])).to(device)  # a writable copy

    glom = GlomParams(
        token_embed=LinearParams(t("token_embed.w"), t("token_embed.b")),
        pos_emb=t("pos_emb"),
        init_levels=t("init_levels"),
        bottom_up=GroupedFFWParams(*(t(f"bottom_up.{k}") for k in FFW_KEYS)),
        top_down=GroupedFFWParams(*(t(f"top_down.{k}") for k in FFW_KEYS)),
    )
    if len(keys) == len(PARAM_KEYS):
        return glom
    from glom_tpu_torch.train.objectives import DenoiseParams  # models <- train

    return DenoiseParams(glom, LinearParams(t("to_pixels.w"), t("to_pixels.b")))
