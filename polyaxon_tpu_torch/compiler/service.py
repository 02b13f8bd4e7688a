"""Spec compiler: a spec document -> validated specification -> gang plan.

The port's copy of ``polyaxon_tpu/compiler/service.py`` (``GangPlan`` and
``compile_gang_plan``, :22-109): the concrete process topology the spawner
executes (host count, devices a host, mesh axes, restart policy, service
port, env).  The input is a dict or a specification; the reference's
``PolyaxonFile`` (yaml or json text, files on disk) stays with the control
plane.  The port's spawner takes any object with these fields, so a JAX
``GangPlan`` launches port workers as well.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Union

from polyaxon_tpu_torch.exceptions import CompilerError, SchemaError
from polyaxon_tpu_torch.schemas.polyaxonfile import PolyaxonFile
from polyaxon_tpu_torch.schemas.specifications import (
    BaseSpecification,
    specification_for_kind,
)


@dataclass(frozen=True)
class GangPlan:
    """Everything the spawner needs to launch one gang."""

    num_hosts: int
    devices_per_host: int
    mesh_axes: Dict[str, int]
    strategy: str
    strategy_options: Dict[str, Any] = field(default_factory=dict)
    accelerator: str = "cpu"
    env_vars: Dict[str, str] = field(default_factory=dict)
    max_restarts: int = 0
    backoff_seconds: float = 1.0
    #: Service kinds only: the port the service must bind. None = not a
    #: service; 0 = allocate at dispatch time.
    service_port: Optional[int] = None
    #: Cross-slice mesh axes, a subset of ``mesh_axes``; empty for
    #: single-slice gangs.
    dcn_axes: Dict[str, int] = field(default_factory=dict)

    @property
    def world_size(self) -> int:
        """The gang's rank processes: one a host on a ``cpu*`` plan, one a
        card otherwise (``spawner.local.rank_plan``)."""
        if self.accelerator.startswith("cpu"):
            return self.num_hosts
        return self.num_hosts * self.devices_per_host

    @property
    def num_devices(self) -> int:
        return self.num_hosts * self.devices_per_host

    @property
    def num_slices(self) -> int:
        n = 1
        for size in self.dcn_axes.values():
            n *= int(size)
        return n


def compile_spec(
    values: Union[Dict[str, Any], BaseSpecification], kind: Optional[str] = None
) -> BaseSpecification:
    """Validate a spec dict into a typed specification (a specification is
    taken as it is).  The kind is read as the reference's loader reads it
    (``PolyaxonFile._normalize``): a document with ``hptuning`` or a legacy
    top-level ``matrix`` is a group, which no worker runs, and one with
    neither and no ``kind`` an experiment.  ``kind`` (when given) must
    match."""
    if isinstance(values, BaseSpecification):
        spec = values
    elif isinstance(values, dict):
        data = PolyaxonFile._normalize(dict(values))
        spec = specification_for_kind(data["kind"]).from_dict(data)
    else:
        raise SchemaError(f"Spec document must be a mapping, got {type(values)}")
    if kind is not None and spec.kind != kind:
        raise CompilerError(f"Spec kind {spec.kind!r} does not match requested {kind!r}")
    return spec


def compile_gang_plan(spec: Union[Dict[str, Any], BaseSpecification]) -> GangPlan:
    """Emit the concrete gang topology for a runnable spec."""
    spec = compile_spec(spec)
    topo = spec.environment.topology
    try:
        ici_axes = topo.resolved_mesh()
        dcn_axes = topo.resolved_dcn()
    except ValueError as e:
        raise CompilerError(str(e)) from e
    # The combined logical mesh; DCN axes lead.
    mesh_axes = {**dcn_axes, **ici_axes}
    # Service kinds carry a port (0 defers allocation to dispatch); a
    # declared `port` pins it, so the advertised URL names the bound port.
    service_port = getattr(spec, "port", None)
    if service_port == 0 and spec.declarations.get("port"):
        service_port = int(spec.declarations["port"])
    return GangPlan(
        num_hosts=int(topo.num_hosts) * int(topo.num_slices),
        devices_per_host=topo.devices_per_host,
        mesh_axes=mesh_axes,
        strategy=topo.strategy,
        strategy_options=dict(topo.strategy_options),
        accelerator=topo.accelerator,
        env_vars=dict(spec.environment.env_vars),
        max_restarts=spec.environment.restart_policy.max_restarts,
        backoff_seconds=spec.environment.restart_policy.backoff_seconds,
        service_port=service_port,
        dcn_axes=dcn_axes,
    )
