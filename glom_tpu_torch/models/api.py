"""The user-facing `Glom` module: the reference's public API.

Counterpart of `glom_tpu/models/api.py`. Reference parity:
`Glom(dim=512, levels=6, image_size=224, patch_size=14,
consensus_self=False, local_consensus_radius=0)` and
`forward(img, iters=None, levels=None, return_all=False)`
(glom_pytorch/glom_pytorch.py:76-83, :103), plus `compute_dtype`,
`use_pallas`, `params` and the `iters="auto"` early exit's
`exit_threshold`, `auto_max_iters` and `auto_min_iters` as in glom_tpu,
and `device` and `generator`.

The parameters are buffers of the module (this slice is forward-only), so
`.to(device)` moves them. The forward runs under `torch.no_grad()`.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from glom_tpu_torch.models.core import GlomParams, glom_forward, init_glom
from glom_tpu_torch.ops.ffw import GroupedFFWParams
from glom_tpu_torch.ops.patch import LinearParams
from glom_tpu_torch.utils.config import GlomConfig
from glom_tpu_torch.utils.helpers import resolve_device, resolve_dtype

_FLAT = (
    "token_embed_w", "token_embed_b", "pos_emb", "init_levels",
    "bottom_up_w1", "bottom_up_b1", "bottom_up_w2", "bottom_up_b2",
    "top_down_w1", "top_down_b1", "top_down_w2", "top_down_b2",
)


class Glom(nn.Module):
    def __init__(
        self,
        *,
        dim: int = 512,
        levels: int = 6,
        image_size: int = 224,
        patch_size: int = 14,
        consensus_self: bool = False,
        local_consensus_radius: int = 0,
        compute_dtype=None,
        use_pallas: Optional[bool] = None,
        params: Optional[GlomParams] = None,
        mesh=None,
        device="cuda",
        generator: Optional[torch.Generator] = None,
        exit_threshold: float = 1e-3,
        auto_max_iters: Optional[int] = None,
        auto_min_iters: int = 1,
    ):
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (sharded forward) is not ported yet: ROADMAP queue A item 8b"
            )
        device = resolve_device(device)
        self.config = GlomConfig(
            dim=dim,
            levels=levels,
            image_size=image_size,
            patch_size=patch_size,
            consensus_self=consensus_self,
            local_consensus_radius=local_consensus_radius,
        )
        self.compute_dtype = resolve_dtype(compute_dtype)
        # glom_tpu's default on its accelerator is the fused kernel path.
        self.use_pallas = True if use_pallas is None else use_pallas
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = init_glom(self.config, generator=generator)
        flat = (
            *params.token_embed, params.pos_emb, params.init_levels,
            *params.bottom_up, *params.top_down,
        )
        for name, t in zip(_FLAT, flat):
            self.register_buffer(name, t.to(device))
        # The iters="auto" policy (serve/early_exit.glom_forward_auto):
        # exit once no level's agreement moves more than exit_threshold
        # between iterations, within auto_max_iters (None: 2L) and after
        # auto_min_iters.
        self.exit_threshold = exit_threshold
        self.auto_max_iters = auto_max_iters
        self.auto_min_iters = auto_min_iters
        # How many iterations the last iters="auto" call ran: a 0-d int32
        # tensor on the module's device (read it with int(...)).
        self.last_auto_iters: Optional[torch.Tensor] = None

    @property
    def params(self) -> GlomParams:
        def g(name):
            return getattr(self, name)

        return GlomParams(
            token_embed=LinearParams(g("token_embed_w"), g("token_embed_b")),
            pos_emb=g("pos_emb"),
            init_levels=g("init_levels"),
            bottom_up=GroupedFFWParams(*(g(f"bottom_up_{k}") for k in ("w1", "b1", "w2", "b2"))),
            top_down=GroupedFFWParams(*(g(f"top_down_{k}") for k in ("w1", "b1", "w2", "b2"))),
        )

    @torch.no_grad()
    def forward(
        self,
        img: torch.Tensor,
        iters: Union[int, str, None] = None,
        levels: Optional[torch.Tensor] = None,
        return_all: bool = False,
    ) -> torch.Tensor:
        """img [b, c, H, W] -> levels [b, n, L, d] ([T+1, ...] with return_all).

        iters="auto" runs the consensus early exit: up to auto_max_iters
        updates, stopping once no level's agreement moves more than
        exit_threshold between iterations; the count lands on
        `last_auto_iters`. At exit_threshold 0.0 exactly auto_max_iters
        updates run. The auto route runs the reference layout with K1 and
        plain dense consensus (one witness across routes, as glom_tpu's),
        so with use_pallas it agrees with the fixed fused route to kernel
        tolerance, not bit for bit."""
        dev = self.pos_emb.device
        img = torch.as_tensor(img, device=dev)
        if levels is not None:
            levels = torch.as_tensor(levels, device=dev)
        if iters == "auto":
            if return_all:
                raise ValueError(
                    "iters='auto' is incompatible with return_all=True: the "
                    "early exit makes the number of stacked states data-dependent"
                )
            # Imported here to keep the models layer below serve.
            from glom_tpu_torch.serve.early_exit import glom_forward_auto

            max_iters = (self.auto_max_iters if self.auto_max_iters is not None
                         else self.config.default_iters)
            final, iters_run, _ = glom_forward_auto(
                self.params, img, self.config, max_iters=max_iters,
                threshold=self.exit_threshold, min_iters=self.auto_min_iters,
                levels=levels, compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
            )
            self.last_auto_iters = torch.tensor(iters_run, dtype=torch.int32, device=dev)
            return final
        return glom_forward(
            self.params,
            img,
            self.config,
            iters=iters,
            levels=levels,
            return_all=return_all,
            compute_dtype=self.compute_dtype,
            use_pallas=self.use_pallas,
        )
