"""Serving: the inference engine and the host stack over it.

The port's counterparts of glom_tpu's `serve/`:

    engine        InferenceEngine: params and one forward per dispatch
                  signature (bucket, route, warm form), warmup, retry,
                  per-signature latency stats
    early_exit    the auto, tiered, incremental and ragged forwards
    paged_columns PagedColumnPool: the device page pool behind the warm
                  paged route and ragged admission
    batcher       DynamicBatcher: bounded admission, max_batch /
                  max_delay_ms gathering, pad-to-bucket with a mask, the
                  continuation queue, multi-engine fan-out with failover
                  and rejoin, the shed path; `pack_ragged`
                  and the elastic fleet methods (add_engine,
                  begin_drain, drain_engine, husk retention)
    column_cache  ColumnCache: session-keyed warm-start column state and
                  the drain's device-to-device session migration
    elastic       ElasticPolicy and Autoscaler: the SLO-driven control
                  loop (scale-out with warm-pool spares, graceful
                  scale-in, stamped decision records)
    qos           SLO classes and the weighted-fair admission lane
    workload      record, write, load, generate and replay traffic
    events        the serve-record emitter
    cli           `python -m glom_tpu_torch.serve`
"""

from glom_tpu_torch.serve.batcher import (
    BackendDownError,
    DynamicBatcher,
    LadderShedError,
    QueueFullError,
    ShedError,
    Ticket,
    pack_ragged,
)
from glom_tpu_torch.serve.column_cache import (
    ColumnCache,
    PageHit,
    column_state_bytes,
    resolve_column_cache,
)
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
from glom_tpu_torch.serve.elastic import SCALE_EVENTS, Autoscaler, ElasticPolicy, resolve_policy
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
from glom_tpu_torch.serve.qos import (
    ClassQueues,
    QosSpec,
    SLOClass,
    class_slo_rules,
    parse_slo_class,
    resolve_slo_classes,
)

__all__ = [
    "Autoscaler",
    "BackendDownError",
    "ClassQueues",
    "ColumnCache",
    "DynamicBatcher",
    "ElasticPolicy",
    "InferenceEngine",
    "LadderShedError",
    "PageHit",
    "PagedColumnPool",
    "QosSpec",
    "QueueFullError",
    "RaggedResult",
    "RaggedServeResult",
    "SCALE_EVENTS",
    "SLOClass",
    "ServeResult",
    "ShedError",
    "Ticket",
    "TieredAutoResult",
    "batch_agreement",
    "class_slo_rules",
    "column_state_bytes",
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
    "parse_slo_class",
    "ragged_row_layout",
    "resolve_column_cache",
    "resolve_page_pool",
    "resolve_page_tokens",
    "resolve_policy",
    "resolve_slo_classes",
    "stamp_serve",
    "support_agreement",
]
