"""Serving of the port (counterpart of ``polyaxon_tpu.serving``): the paged
continuous-batching engine, its block bookkeeping and host KV tier, the
persistent prefix store (``serving.kvstore``), and the fleet: replica
subprocesses (``serving.replica``) behind the :class:`FleetRouter`, started
by :class:`LocalServingFleet` and resized by the :class:`FleetAutoscaler`."""

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
from polyaxon_tpu_torch.serving.router import FleetRouter, RouterError
from polyaxon_tpu_torch.serving.fleet import LocalServingFleet
from polyaxon_tpu_torch.serving.autoscaler import FleetAutoscaler

__all__ = [
    "BlockAllocator",
    "EngineDrainingError",
    "FleetAutoscaler",
    "FleetRouter",
    "GenerationRequest",
    "HostKVTier",
    "LocalServingFleet",
    "NgramDrafter",
    "PrefixCache",
    "RouterError",
    "ServingEngine",
    "SlotAllocator",
    "truncate_table",
]
