from glom_tpu_torch.serve.batcher import pack_ragged
from glom_tpu_torch.serve.early_exit import (
    RaggedResult,
    TieredAutoResult,
    glom_forward_auto,
    glom_forward_ragged,
    glom_forward_tiered,
)
from glom_tpu_torch.serve.engine import InferenceEngine, RaggedServeResult, ServeResult
from glom_tpu_torch.serve.paged_columns import pages_for_tokens, resolve_page_tokens

__all__ = [
    "InferenceEngine",
    "RaggedResult",
    "RaggedServeResult",
    "ServeResult",
    "TieredAutoResult",
    "glom_forward_auto",
    "glom_forward_ragged",
    "glom_forward_tiered",
    "pack_ragged",
    "pages_for_tokens",
    "resolve_page_tokens",
]
