"""The five benchmark configurations (BASELINE.md) as named presets.

Counterpart of `glom_tpu/utils/presets.py`: the same names, model, train
and mesh configs, and `scaled_to`. Each preset bundles the model config, a
training config, and the mesh / SP strategy the config was designed to
exercise. Mesh sizes describe the TARGET topology; `scaled_to(num_devices)`
shrinks the mesh to what is available; the training CLI's
`--distributed` runs DistributedTrainer on it (`glom_tpu_torch.parallel`).

`serve` holds the fields of glom_tpu's serving policy that the port's
`ServeConfig` has: the engine's, the page pool's and the host stack's
(admission delay, queue depth, column cache bytes and TTL, rejoin
threshold) and the serve mesh's axes (mesh_data, mesh_seq).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from glom_tpu_torch.utils.config import GlomConfig, MeshConfig, ServeConfig, TrainConfig
from glom_tpu_torch.utils.helpers import halo_supported


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    description: str
    model: GlomConfig
    train: TrainConfig
    mesh: MeshConfig
    sp_strategy: str = "none"  # none | ring | ulysses | halo | auto
    serve: ServeConfig = ServeConfig()

    def scaled_to(self, num_devices: int) -> "Preset":
        """Shrink the mesh to fit `num_devices`. Data parallelism is the
        elastic axis: it shrinks FIRST, so the seq and model axes survive
        on small device counts. Halving an axis keeps batch % data == 0
        and num_patches % seq == 0. A shrunk mesh is one slice."""
        data, seq, model = self.mesh.data, self.mesh.seq, self.mesh.model
        while data * seq * model > num_devices and data > 1:
            data //= 2
        while data * seq * model > num_devices and seq > 1:
            seq //= 2
        while data * seq * model > num_devices and model > 1:
            model //= 2
        shrunk = (data, seq, model) != self.mesh.shape
        ns = 1 if shrunk else self.mesh.num_slices
        mesh = MeshConfig(data=data, seq=seq, model=model, num_slices=ns)
        sp = self.sp_strategy if mesh.seq > 1 else "none"
        if sp == "halo" and not halo_supported(
            mesh.seq, self.model.num_patches_side, self.model.local_consensus_radius
        ):
            # Fewer rows per shard can break halo's one-hop precondition;
            # ring is exact for any radius.
            sp = "ring"
        return dataclasses.replace(self, mesh=mesh, sp_strategy=sp)


PRESETS: Dict[str, Preset] = {}


def _register(p: Preset) -> Preset:
    PRESETS[p.name] = p
    return p


_BF16_TRAIN = dict(
    learning_rate=3e-4, noise_std=0.5, compute_dtype="bfloat16", use_pallas=True
)

# 1. MNIST 28x28, patch=7, levels=4, dim=128: the correctness reference.
_register(
    Preset(
        name="mnist",
        description="MNIST 28x28 p7 L4 d128 — correctness reference",
        model=GlomConfig(dim=128, levels=4, image_size=28, patch_size=7),
        train=TrainConfig(batch_size=32, learning_rate=3e-4, noise_std=0.5),
        mesh=MeshConfig(),
    )
)

# 2. CIFAR-10 32x32, patch=4, levels=5, dim=256: denoise training.
_register(
    Preset(
        name="cifar10",
        description="CIFAR-10 32x32 p4 L5 d256 — self-supervised denoise train",
        model=GlomConfig(dim=256, levels=5, image_size=32, patch_size=4),
        train=TrainConfig(batch_size=64, scan_unroll=True, **_BF16_TRAIN),
        mesh=MeshConfig(),
    )
)

# 3. ImageNet-64, patch=8, levels=6, dim=512, local consensus radius 7. On
# side 8 sharded seq=2 a shard holds 4 rows < radius 7, so halo can never
# hold; 'auto' picks a global SP form.
_register(
    Preset(
        name="imagenet64-local",
        description="ImageNet-64 p8 L6 d512 radius7 — local-mask path",
        model=GlomConfig(dim=512, levels=6, image_size=64, patch_size=8, local_consensus_radius=7),
        train=TrainConfig(batch_size=64, scan_unroll=True, **_BF16_TRAIN),
        mesh=MeshConfig(data=4, seq=2),
        sp_strategy="auto",
    )
)

# 3b. The long-context local-consensus config where halo pays: side 32
# (n = 1024), radius 7, seq=4 gives 8 rows per shard >= 7 halo rows.
_register(
    Preset(
        name="imagenet256-local",
        description="ImageNet-256 p8 L6 d512 radius7 — halo-exchange long-context",
        model=GlomConfig(dim=512, levels=6, image_size=256, patch_size=8, local_consensus_radius=7),
        train=TrainConfig(batch_size=32, scan_unroll=True, **_BF16_TRAIN),
        mesh=MeshConfig(data=2, seq=4),
        sp_strategy="auto",
    )
)

# 4. ImageNet-224, patch=14, levels=6, dim=512: the flagship. Its serving
# policy: bf16 fused forward, a deeper bucket ladder, two-tier early exit
# with continuations, and the paged pool (1 GiB of 64-token pages, aliased
# write-backs).
_register(
    Preset(
        name="imagenet224-dp8",
        description="ImageNet-224 p14 L6 d512 — DP over a v5e-8 slice",
        model=GlomConfig(dim=512, levels=6, image_size=224, patch_size=14),
        train=TrainConfig(batch_size=64, scan_unroll=True, **_BF16_TRAIN),
        mesh=MeshConfig(data=8),
        serve=ServeConfig(
            buckets=(1, 2, 4, 8, 16),
            max_batch=16,
            max_delay_ms=3.0,
            queue_depth=256,
            iters="auto",
            exit_threshold=1e-3,
            min_iters=4,
            exit_quorum=0.75,
            max_continuations=2,
            compute_dtype="bfloat16",
            use_pallas=True,
            column_cache_bytes=1 << 30,
            column_cache_ttl_s=60.0,
            rejoin_threshold=3,
            page_pool_pages=2728,
            page_tokens=64,
            ragged_attention="banded",
            pool_aliasing=True,
        ),
    )
)

# 5. ImageNet-224, patch=14, levels=12, dim=1024: pod scale with remat,
# 4 slices of 64 chips.
_register(
    Preset(
        name="imagenet224-pod",
        description="ImageNet-224 p14 L12 d1024 — v5e-256 pod (4 DCN slices), remat",
        model=GlomConfig(dim=1024, levels=12, image_size=224, patch_size=14),
        train=TrainConfig(
            batch_size=256,
            learning_rate=3e-4,
            noise_std=0.5,
            compute_dtype="bfloat16",
            use_pallas=True,
            remat=True,
        ),
        mesh=MeshConfig(data=64, seq=2, model=2, num_slices=4),
        sp_strategy="auto",
        serve=ServeConfig(
            buckets=(4, 8, 16, 32),
            max_batch=32,
            max_delay_ms=5.0,
            queue_depth=512,
            iters="auto",
            exit_threshold=1e-3,
            min_iters=4,
            exit_quorum=0.75,
            max_continuations=2,
            # Each engine replica is a data 4 x seq 2 serve mesh of ranks.
            mesh_data=4,
            mesh_seq=2,
            compute_dtype="bfloat16",
            column_cache_bytes=2 << 30,
            column_cache_ttl_s=60.0,
            rejoin_threshold=3,
            page_pool_pages=1364,
            page_tokens=64,
        ),
    )
)


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
