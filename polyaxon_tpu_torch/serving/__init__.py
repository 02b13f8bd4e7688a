"""Serving of the port (counterpart of ``polyaxon_tpu.serving``): the paged
continuous-batching engine, its block bookkeeping and host KV tier, and the
persistent prefix store (``serving.kvstore``).  The fleet's pieces
(``FleetAutoscaler``, the router, replicas) are not ported yet (ROADMAP
Queue 1 item 4, step 7)."""

from polyaxon_tpu_torch.serving.engine import (
    EngineDrainingError,
    GenerationRequest,
    NgramDrafter,
    ServingEngine,
    SlotAllocator,
)
from polyaxon_tpu_torch.serving.paging import (
    BlockAllocator,
    HostKVTier,
    PrefixCache,
    truncate_table,
)

__all__ = [
    "BlockAllocator",
    "EngineDrainingError",
    "GenerationRequest",
    "HostKVTier",
    "NgramDrafter",
    "PrefixCache",
    "ServingEngine",
    "SlotAllocator",
    "truncate_table",
]
