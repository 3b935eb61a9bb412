"""Serving: the inference engine, its early-exit, incremental and ragged
forwards, the device page pool and the serve-record emitter (the port's
counterparts of glom_tpu's `serve/engine.py`, `early_exit.py`,
`paged_columns.py` and `events.py`, with `batcher.py`'s packing). The
host stack over the engine (batcher, QoS, column cache, elastic serving,
the CLI) is ROADMAP queue A item 7's next part."""

from glom_tpu_torch.serve.batcher import pack_ragged
from glom_tpu_torch.serve.early_exit import (
    RaggedResult,
    TieredAutoResult,
    batch_agreement,
    glom_forward_auto,
    glom_forward_incremental,
    glom_forward_ragged,
    glom_forward_tiered,
    masked_level_agreement,
    ragged_row_layout,
    support_agreement,
)
from glom_tpu_torch.serve.engine import InferenceEngine, RaggedServeResult, ServeResult
from glom_tpu_torch.serve.events import emit_serve, stamp_serve
from glom_tpu_torch.serve.paged_columns import (
    PagedColumnPool,
    content_hash,
    page_state_bytes,
    pages_for_tokens,
    resolve_page_pool,
    resolve_page_tokens,
)

__all__ = [
    "InferenceEngine",
    "PagedColumnPool",
    "RaggedResult",
    "RaggedServeResult",
    "ServeResult",
    "TieredAutoResult",
    "batch_agreement",
    "content_hash",
    "emit_serve",
    "glom_forward_auto",
    "glom_forward_incremental",
    "glom_forward_ragged",
    "glom_forward_tiered",
    "masked_level_agreement",
    "pack_ragged",
    "page_state_bytes",
    "pages_for_tokens",
    "ragged_row_layout",
    "resolve_page_pool",
    "resolve_page_tokens",
    "stamp_serve",
    "support_agreement",
]
