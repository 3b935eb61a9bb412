"""The user-facing `Glom` module: the reference's public API.

Counterpart of `glom_tpu/models/api.py`. Reference parity:
`Glom(dim=512, levels=6, image_size=224, patch_size=14,
consensus_self=False, local_consensus_radius=0)` and
`forward(img, iters=None, levels=None, return_all=False)`
(glom_pytorch/glom_pytorch.py:76-83, :103), plus `compute_dtype`,
`use_pallas`, `params` and the `iters="auto"` early exit's
`exit_threshold`, `auto_max_iters` and `auto_min_iters` as in glom_tpu,
and `device` and `generator`.

`mesh=` (a `MeshConfig`, or a ready mesh: the DeviceMesh of
`parallel/mesh.make_mesh`) runs the forward across torch.distributed
ranks through `parallel/manual.make_manual_forward`, with `sp_strategy`
picking how consensus crosses the 'seq' axis. Every rank calls the module
with the global batch and gets the global answer; the kernels run on each
rank's band. glom_tpu drops Pallas for a mesh without 'data' and 'seq'
axes and takes its GSPMD forward; the port has no GSPMD and raises.

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
        sp_strategy: str = "none",
        device="cuda",
        generator: Optional[torch.Generator] = None,
        exit_threshold: float = 1e-3,
        auto_max_iters: Optional[int] = None,
        auto_min_iters: int = 1,
    ):
        super().__init__()
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
        self.mesh = _resolve_mesh(mesh, device)
        if self.mesh is not None:
            from glom_tpu_torch.parallel.manual import rank_axes

            seq = rank_axes(self.mesh).seq.size
            if self.config.num_patches % seq:
                raise ValueError(
                    f"patches {self.config.num_patches} not divisible by seq axis {seq}"
                )
        self.sp_strategy = sp_strategy
        self._sharded = {}
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
            if self.mesh is not None:
                raise NotImplementedError(
                    "iters='auto' is single-device (serving buckets replicate "
                    "the model); drop mesh= or use a fixed iteration count"
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
        if self.mesh is not None:
            return self._sharded_forward(iters, return_all, levels is not None)(
                self.params, img, *(() if levels is None else (levels,)))
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

    def _sharded_forward(self, iters, return_all: bool, with_levels: bool):
        """make_manual_forward for one (iters, return_all, levels-presence),
        memoized."""
        from glom_tpu_torch.parallel.manual import make_manual_forward

        iters = iters if iters is not None else self.config.default_iters
        key = (iters, return_all, with_levels)
        if key not in self._sharded:
            self._sharded[key] = make_manual_forward(
                self.mesh, self.config, iters=iters, sp_strategy=self.sp_strategy,
                compute_dtype=self.compute_dtype, use_pallas=self.use_pallas,
                return_all=return_all, with_levels=with_levels,
            )
        return self._sharded[key]


def _resolve_mesh(mesh, device: torch.device):
    """None, or the rank mesh `Glom(mesh=)` runs over: a MeshConfig is laid
    over the process group (each rank on `device`, or on cuda:LOCAL_RANK
    for a bare "cuda"); a ready mesh must name the 'data' and 'seq' axes."""
    if mesh is None:
        return None
    from glom_tpu_torch.utils.config import MeshConfig

    if isinstance(mesh, MeshConfig):
        from glom_tpu_torch.parallel.mesh import make_mesh

        devices = None
        if device.type != "cuda" or device.index is not None:
            devices = [device] * mesh.num_devices
        return make_mesh(mesh, devices)[0]
    names = set(getattr(mesh, "mesh_dim_names", None) or ())
    if not {"data", "seq"} <= names:
        raise ValueError(
            f"mesh axes {sorted(names)}: the per-rank forward needs the 'data' and 'seq' "
            "axes (glom_tpu falls back to its GSPMD forward here; the port has none)"
        )
    return mesh
