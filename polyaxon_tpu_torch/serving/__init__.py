"""Serving of the port (counterpart of ``polyaxon_tpu.serving``): the paged
continuous-batching engine, its block bookkeeping and host KV tier, the
persistent prefix store (``serving.kvstore``), and the fleet: replica
subprocesses (``serving.replica``) behind the :class:`FleetRouter`, started
by :class:`LocalServingFleet` or, as control-plane runs, by
:class:`ServingFleet`, and resized by the :class:`FleetAutoscaler`.

The names load their modules at first use: the router, the fleets and the
autoscaler import no torch, so a control plane that runs a fleet loads none.
"""

import importlib

_MODULES = {
    "EngineDrainingError": "engine",
    "GenerationRequest": "engine",
    "NgramDrafter": "engine",
    "ServingEngine": "engine",
    "SlotAllocator": "engine",
    "BlockAllocator": "paging",
    "HostKVTier": "paging",
    "PrefixCache": "paging",
    "truncate_table": "paging",
    "FleetRouter": "router",
    "RouterError": "router",
    "LocalServingFleet": "fleet",
    "ServingFleet": "fleet",
    "FleetAutoscaler": "autoscaler",
}

__all__ = sorted(_MODULES)


def __getattr__(name):
    module = _MODULES.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
