"""Environment section of a spec: topology, mesh, resources, restart policy.

The port's copy of ``polyaxon_tpu/schemas/environments.py``
(``ACCELERATOR_CATALOG`` :27, ``STRATEGIES`` :54, ``MeshConfig`` :60,
``TopologyConfig`` :103, ``ResourcesConfig`` :195, ``RestartPolicyConfig``
:205, ``EnvironmentConfig`` :219), as
dataclasses with explicit checks.  The catalog is the reference's, so a spec
names the same slices in both packages; an accelerator outside it (``h100``,
say) needs ``num_devices`` and ``num_hosts``, as there:
``{"accelerator": "h100", "num_devices": 1, "num_hosts": 1}`` validates in
both.  The port's worker runs the card for any accelerator not named
``cpu*`` (``runtime/worker.py``).  The schema's default accelerator stays
the reference's ``cpu`` (``to_dict`` is the reference's); what a run row
stores is :meth:`TopologyConfig.stored`, which names the card where the spec
named no accelerator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from polyaxon_tpu_torch.schemas.fields import (
    as_dict,
    as_float,
    as_int,
    as_int_dict,
    as_str,
    as_str_dict,
    at_least,
    check_keys,
    drop_none,
    optional,
)

#: Known accelerator slice shapes: name -> (num_chips, num_hosts), the
#: reference's table (``cpu``: 8 virtual devices on one host).
ACCELERATOR_CATALOG: Dict[str, Tuple[int, int]] = {
    "cpu": (8, 1),
    "cpu-1": (1, 1),
    "v4-8": (4, 1),
    "v4-16": (8, 2),
    "v4-32": (16, 4),
    "v5e-1": (1, 1),
    "v5e-4": (4, 1),
    "v5e-8": (8, 1),
    "v5e-16": (16, 2),
    "v5e-32": (32, 4),
    "v5e-64": (64, 8),
    "v5e-128": (128, 16),
    "v5e-256": (256, 32),
    "v5p-8": (4, 1),
    "v5p-16": (8, 2),
    "v5p-32": (16, 4),
    "v6e-8": (8, 1),
    "v6e-16": (16, 2),
    "v6e-32": (32, 4),
}

#: The topology a run whose spec names none is stored with: one card, which
#: the port's worker runs (``runtime/worker.py:device_and_backend``).
CARD_TOPOLOGY: Dict[str, Any] = {"accelerator": "h100", "num_devices": 1, "num_hosts": 1}

#: Canonical mesh axis names, outermost (data-like) first, innermost last.
CANONICAL_AXES = ("replica", "data", "fsdp", "pipeline", "expert", "sequence", "tensor")

STRATEGIES = (
    "ddp", "fsdp", "tp", "tp_dp", "pp", "pp_tp", "sp_ring", "ulysses", "ep",
    "custom",
)


@dataclass
class MeshConfig:
    """Ordered logical mesh: axis name -> size. One axis may be -1 (infer)."""

    axes: Dict[str, int]

    def __post_init__(self) -> None:
        v = self.axes
        if not v:
            raise ValueError("mesh must declare at least one axis")
        wildcards = [k for k, s in v.items() if s == -1]
        if len(wildcards) > 1:
            raise ValueError(f"At most one -1 axis allowed, got {wildcards}")
        for k, s in v.items():
            if s != -1 and s < 1:
                raise ValueError(f"Axis {k!r} must be >= 1 or -1, got {s}")

    @classmethod
    def from_dict(cls, data: Any, where: str = "mesh") -> "MeshConfig":
        if isinstance(data, MeshConfig):
            return data
        if isinstance(data, dict) and "axes" not in data:
            data = {"axes": data}  # the reference's shorthand: {data: -1, tensor: 2}
        d = check_keys(data, ("axes",), where)
        if "axes" not in d:
            raise ValueError(f"{where}.axes: Field required")
        return cls(axes=as_int_dict(d["axes"], f"{where}.axes"))

    @property
    def names(self) -> List[str]:
        return list(self.axes)

    def resolve(self, num_devices: int) -> Dict[str, int]:
        """Fill a -1 wildcard axis and check the product matches devices."""
        axes = dict(self.axes)
        wildcard = next((k for k, s in axes.items() if s == -1), None)
        known = math.prod(s for s in axes.values() if s != -1)
        if wildcard is not None:
            if num_devices % known != 0:
                raise ValueError(
                    f"Cannot infer axis {wildcard!r}: {num_devices} devices not "
                    f"divisible by {known}"
                )
            axes[wildcard] = num_devices // known
        elif known != num_devices:
            raise ValueError(
                f"Mesh product {known} != device count {num_devices} ({axes})"
            )
        return axes

    def to_dict(self) -> Dict[str, Any]:
        return {"axes": dict(self.axes)}


@dataclass
class TopologyConfig:
    """Accelerator slice + logical mesh + parallelism strategy."""

    accelerator: str = "cpu"
    num_hosts: Optional[int] = None
    num_devices: Optional[int] = None
    mesh: Optional[MeshConfig] = None
    #: Multi-slice: per-slice topology above, slice count here; ``dcn_axis``
    #: becomes the leading mesh axis spanning slices.
    num_slices: int = 1
    dcn_axis: str = "replica"
    strategy: str = "ddp"
    #: Extra knobs for templates (e.g. microbatches for pp).
    strategy_options: Dict[str, Any] = field(default_factory=dict)

    _KEYS = ("accelerator", "num_hosts", "num_devices", "mesh", "num_slices", "dcn_axis",
             "strategy", "strategy_options")

    @classmethod
    def from_dict(cls, data: Any, where: str = "topology") -> "TopologyConfig":
        d = check_keys(data, cls._KEYS, where)
        out = cls()
        out._given = dict(d)
        if "accelerator" in d:
            out.accelerator = as_str(d["accelerator"], f"{where}.accelerator")
        for name in ("num_hosts", "num_devices"):
            value = optional(as_int)(d.get(name), f"{where}.{name}")
            at_least(value, 1, f"{where}.{name}")
            setattr(out, name, value)
        if d.get("mesh") is not None:
            out.mesh = MeshConfig.from_dict(d["mesh"], f"{where}.mesh")
        if "num_slices" in d:
            out.num_slices = as_int(d["num_slices"], f"{where}.num_slices")
            at_least(out.num_slices, 1, f"{where}.num_slices")
        if "dcn_axis" in d:
            out.dcn_axis = as_str(d["dcn_axis"], f"{where}.dcn_axis")
        if "strategy" in d:
            out.strategy = as_str(d["strategy"], f"{where}.strategy")
            if out.strategy not in STRATEGIES:
                raise ValueError(f"strategy must be one of {STRATEGIES}")
        if "strategy_options" in d:
            out.strategy_options = as_dict(d["strategy_options"], f"{where}.strategy_options")
        out._fill_from_catalog()
        return out

    def _fill_from_catalog(self) -> None:
        cat = ACCELERATOR_CATALOG.get(self.accelerator)
        if cat is not None:
            chips, hosts = cat
            if self.num_devices is None:
                self.num_devices = chips
            if self.num_hosts is None:
                self.num_hosts = hosts
        elif self.num_devices is None or self.num_hosts is None:
            raise ValueError(
                f"Unknown accelerator {self.accelerator!r}: set num_devices "
                f"and num_hosts explicitly (known: {sorted(ACCELERATOR_CATALOG)})"
            )
        if self.num_devices % self.num_hosts != 0:
            raise ValueError(
                f"num_devices ({self.num_devices}) must be divisible by "
                f"num_hosts ({self.num_hosts})"
            )
        if self.mesh is not None:
            self.mesh.resolve(self.num_devices)  # raises if inconsistent
        if self.num_slices > 1:
            # The cross-slice axis must be data-like and must not collide
            # with a per-slice axis (checked on the resolved mesh).
            data_like = ("replica", "data", "fsdp")
            if self.dcn_axis not in data_like:
                raise ValueError(
                    f"dcn_axis {self.dcn_axis!r} must be a data-like axis "
                    f"{data_like}: cross-slice (DCN) bandwidth only suits "
                    "batch-gradient traffic"
                )
            if self.dcn_axis in self.resolved_mesh():
                raise ValueError(
                    f"dcn_axis {self.dcn_axis!r} collides with a per-slice "
                    "(ICI) mesh axis; the cross-slice axis must differ"
                )

    def stored(self) -> "TopologyConfig":
        """The topology a run row stores, which is the one that runs: this one
        where the spec names an accelerator; else one card
        (:data:`CARD_TOPOLOGY`) under the spec's other keys, with as many
        devices as a given mesh's fixed axes hold."""
        given = getattr(self, "_given", {})
        if "accelerator" in given:
            return self
        data = {**CARD_TOPOLOGY, **given}
        if "num_devices" not in given and self.mesh is not None:
            data["num_devices"] = math.prod(s for s in self.mesh.axes.values() if s != -1)
        return TopologyConfig.from_dict(data)

    def resolved_mesh(self) -> Dict[str, int]:
        """Per-slice axis->size mapping (default: pure data parallel)."""
        if self.mesh is None:
            return {"data": int(self.num_devices)}
        return self.mesh.resolve(int(self.num_devices))

    def resolved_dcn(self) -> Dict[str, int]:
        """The cross-slice axes; empty for single-slice runs."""
        if self.num_slices <= 1:
            return {}
        return {self.dcn_axis: int(self.num_slices)}

    @property
    def devices_per_host(self) -> int:
        return int(self.num_devices) // int(self.num_hosts)

    def to_dict(self) -> Dict[str, Any]:
        return drop_none({k: getattr(self, k) for k in self._KEYS})


@dataclass
class ResourcesConfig:
    """Host-process resource requests (the reference's k8s resources block)."""

    cpu: Optional[float] = None
    memory_mb: Optional[int] = None
    tpu: Optional[int] = None

    @classmethod
    def from_dict(cls, data: Any, where: str = "resources") -> "ResourcesConfig":
        d = check_keys(data, ("cpu", "memory_mb", "tpu"), where)
        return cls(
            cpu=optional(as_float)(d.get("cpu"), f"{where}.cpu"),
            memory_mb=optional(as_int)(d.get("memory_mb"), f"{where}.memory_mb"),
            tpu=optional(as_int)(d.get("tpu"), f"{where}.tpu"),
        )

    def to_dict(self) -> Dict[str, Any]:
        return drop_none({"cpu": self.cpu, "memory_mb": self.memory_mb, "tpu": self.tpu})


@dataclass
class RestartPolicyConfig:
    """Gang restart policy: any process failure restarts the whole gang."""

    max_restarts: int = 0
    backoff_seconds: float = 1.0

    @classmethod
    def from_dict(cls, data: Any, where: str = "restart_policy") -> "RestartPolicyConfig":
        d = check_keys(data, ("max_restarts", "backoff_seconds"), where)
        out = cls()
        if "max_restarts" in d:
            out.max_restarts = as_int(d["max_restarts"], f"{where}.max_restarts")
            at_least(out.max_restarts, 0, f"{where}.max_restarts")
        if "backoff_seconds" in d:
            out.backoff_seconds = as_float(d["backoff_seconds"], f"{where}.backoff_seconds")
            at_least(out.backoff_seconds, 0, f"{where}.backoff_seconds")
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"max_restarts": self.max_restarts, "backoff_seconds": self.backoff_seconds}


@dataclass
class EnvironmentConfig:
    topology: TopologyConfig = field(default_factory=lambda: TopologyConfig.from_dict({}))
    resources: Optional[ResourcesConfig] = None
    restart_policy: RestartPolicyConfig = field(default_factory=RestartPolicyConfig)
    seed: Optional[int] = None
    env_vars: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, data: Any, where: str = "environment") -> "EnvironmentConfig":
        d = check_keys(data, ("topology", "resources", "restart_policy", "seed", "env_vars"),
                       where)
        out = cls()
        if "topology" in d:
            out.topology = TopologyConfig.from_dict(d["topology"], f"{where}.topology")
        if d.get("resources") is not None:
            out.resources = ResourcesConfig.from_dict(d["resources"], f"{where}.resources")
        if "restart_policy" in d:
            out.restart_policy = RestartPolicyConfig.from_dict(
                d["restart_policy"], f"{where}.restart_policy")
        out.seed = optional(as_int)(d.get("seed"), f"{where}.seed")
        if "env_vars" in d:
            out.env_vars = as_str_dict(d["env_vars"], f"{where}.env_vars")
        return out

    def to_dict(self) -> Dict[str, Any]:
        return drop_none({"topology": self.topology, "resources": self.resources,
                          "restart_policy": self.restart_policy, "seed": self.seed,
                          "env_vars": self.env_vars})
