"""Serving of the port (counterpart of ``polyaxon_tpu.serving``): the paged
continuous-batching engine and its block bookkeeping."""

from polyaxon_tpu_torch.serving.engine import (
    EngineDrainingError,
    GenerationRequest,
    NgramDrafter,
    ServingEngine,
    SlotAllocator,
)
from polyaxon_tpu_torch.serving.paging import BlockAllocator, PrefixCache, truncate_table

__all__ = [
    "BlockAllocator",
    "EngineDrainingError",
    "GenerationRequest",
    "NgramDrafter",
    "PrefixCache",
    "ServingEngine",
    "SlotAllocator",
    "truncate_table",
]
