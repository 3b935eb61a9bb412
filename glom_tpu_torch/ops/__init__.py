from glom_tpu_torch.ops.consensus import (
    build_local_mask,
    consensus_attention,
    iota_local_mask,
)
from glom_tpu_torch.ops.ffw import (
    GroupedFFWParams,
    grouped_ffw,
    grouped_ffw_lm,
    init_grouped_ffw,
)
from glom_tpu_torch.ops.patch import (
    LinearParams,
    image_to_tokens,
    init_linear,
    patchify,
    tokens_to_image,
    unpatchify,
)

__all__ = [
    "GroupedFFWParams",
    "LinearParams",
    "build_local_mask",
    "consensus_attention",
    "grouped_ffw",
    "grouped_ffw_lm",
    "image_to_tokens",
    "init_grouped_ffw",
    "init_linear",
    "iota_local_mask",
    "patchify",
    "tokens_to_image",
    "unpatchify",
]
