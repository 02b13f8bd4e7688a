"""Typed specifications, the port's copy of
``polyaxon_tpu/schemas/specifications.py``: ``interpolate``, the experiment,
job and service kinds with ``resolved_run``, the group (an hptuning sweep
over an experiment template, with ``get_experiment_spec`` materialising one
trial) and the pipeline (a DAG of ops), and ``specification_for_kind``.
Dataclasses with explicit checks instead of pydantic models; ``from_dict``
accepts and refuses the documents the reference's ``from_dict`` does and
raises :class:`~polyaxon_tpu_torch.exceptions.SchemaError` with the
reference's messages.  Groups and pipelines are control-plane kinds: the
port's ``Orchestrator`` expands them into trial and op runs
(``hpsearch/``, ``polyflow/``), and no gang worker runs them.

A service spec without a run section resolves to the port's own built-in
(``builtins/services.py``), kind for kind as the reference's:
``kind: tensorboard`` to ``tensorboard``, ``kind: notebook`` to ``jupyter``
and ``kind: service`` to ``lm_server``.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from polyaxon_tpu_torch.exceptions import SchemaError
from polyaxon_tpu_torch.schemas.environments import EnvironmentConfig
from polyaxon_tpu_torch.schemas.fields import (
    as_dict,
    as_int,
    as_str,
    as_str_list,
    check_keys,
    drop_none,
    optional,
)
from polyaxon_tpu_torch.schemas.hptuning import HPTuningConfig
from polyaxon_tpu_torch.schemas.run import BuildConfig, RunConfig


class Kinds:
    EXPERIMENT = "experiment"
    GROUP = "group"
    JOB = "job"
    BUILD = "build"
    NOTEBOOK = "notebook"
    TENSORBOARD = "tensorboard"
    SERVICE = "service"
    PIPELINE = "pipeline"
    VALUES = (
        EXPERIMENT, GROUP, JOB, BUILD, NOTEBOOK, TENSORBOARD, SERVICE,
        PIPELINE,
    )


_TEMPLATE_RE = re.compile(r"\{\{\s*([\w.]+)\s*\}\}")


def interpolate(value: Any, params: Dict[str, Any]) -> Any:
    """Substitute ``{{ name }}`` templates with declaration values.

    Dotted names traverse nested dicts.  A string that is exactly one
    template resolves to the raw value (keeping its type); mixed strings
    render values inline.
    """

    def lookup(name: str) -> Any:
        node: Any = params
        for part in name.split("."):
            if not isinstance(node, dict) or part not in node:
                raise SchemaError(f"Unknown template variable {name!r}")
            node = node[part]
        return node

    if isinstance(value, str):
        exact = _TEMPLATE_RE.fullmatch(value.strip())
        if exact:
            return lookup(exact.group(1))
        return _TEMPLATE_RE.sub(lambda m: str(lookup(m.group(1))), value)
    if isinstance(value, dict):
        return {k: interpolate(v, params) for k, v in value.items()}
    if isinstance(value, list):
        return [interpolate(v, params) for v in value]
    return value


@dataclass
class BaseSpecification:
    """Common document shape. ``declarations`` are the run's hyperparameters."""

    kind: str
    version: int = 1
    name: Optional[str] = None
    description: Optional[str] = None
    tags: List[str] = field(default_factory=list)
    declarations: Dict[str, Any] = field(default_factory=dict)
    environment: EnvironmentConfig = field(default_factory=EnvironmentConfig)
    build: Optional[BuildConfig] = None

    _BASE_KEYS = ("version", "kind", "name", "description", "tags", "declarations",
                  "environment", "build")
    #: Keys of the kind's own (beyond the base's).
    _KIND_KEYS = ()
    #: The kinds this class takes, and the message that refuses the others.
    _TAKES = ()
    _KIND_MESSAGE = ""

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "BaseSpecification":
        try:
            return cls._validate(data)
        except SchemaError:
            raise
        except (ValueError, TypeError) as e:  # the reference's SchemaError(str(pydantic error))
            raise SchemaError(str(e)) from e

    @classmethod
    def _validate(cls, data: Any) -> "BaseSpecification":
        d = check_keys(data, cls._BASE_KEYS + cls._KIND_KEYS, cls.__name__)
        kind = as_str(d.get("kind", cls._TAKES[0]), "kind")
        if kind not in cls._TAKES:
            raise ValueError(cls._KIND_MESSAGE.format(kind=kind))
        version = as_int(d.get("version", 1), "version")
        if version != 1:
            raise ValueError(f"Unsupported spec version {version}")
        spec = cls(
            kind=kind,
            version=version,
            name=optional(as_str)(d.get("name"), "name"),
            description=optional(as_str)(d.get("description"), "description"),
            tags=as_str_list(d.get("tags", []), "tags"),
            declarations=as_dict(d.get("declarations", {}), "declarations"),
            environment=EnvironmentConfig.from_dict(d.get("environment", {})),
            build=None if d.get("build") is None else BuildConfig.from_dict(d["build"]),
        )
        spec._validate_kind(d)
        return spec

    def _validate_kind(self, d: Dict[str, Any]) -> None:
        """Read the kind's own keys from the checked document ``d``."""

    # -- gang plan (cluster_def equivalent) -----------------------------------
    @property
    def gang_def(self) -> Tuple[int, int]:
        """(num_hosts, devices_per_host)."""
        topo = self.environment.topology
        return int(topo.num_hosts), topo.devices_per_host

    @property
    def mesh_axes(self) -> Dict[str, int]:
        return self.environment.topology.resolved_mesh()

    def to_dict(self) -> Dict[str, Any]:
        keys = self._BASE_KEYS + self._KIND_KEYS
        return drop_none({k: copy.deepcopy(getattr(self, k)) for k in keys})

    def stored_dict(self) -> Dict[str, Any]:
        """The document a run row stores: :meth:`to_dict` with the topology
        that runs (:meth:`TopologyConfig.stored`), so that a spec naming no
        accelerator is stored with the card, not the schema's ``cpu``."""
        data = self.to_dict()
        data["environment"]["topology"] = self.environment.topology.stored().to_dict()
        return data


@dataclass
class ExperimentSpecification(BaseSpecification):
    kind: str = Kinds.EXPERIMENT
    run: Optional[RunConfig] = None

    _KIND_KEYS = ("run",)
    _TAKES = (Kinds.EXPERIMENT,)
    _KIND_MESSAGE = "Expected kind=experiment, got {kind!r}"

    def _validate_kind(self, d: Dict[str, Any]) -> None:
        if "run" not in d:
            raise ValueError("run: Field required")
        self.run = RunConfig.from_dict(d["run"])

    def resolved_run(self) -> RunConfig:
        """Run section with declarations interpolated."""
        data = {"cmd": self.run.cmd, "entrypoint": self.run.entrypoint,
                "kwargs": copy.deepcopy(self.run.kwargs)}
        return RunConfig.from_dict(interpolate(data, self.declarations))


@dataclass
class JobSpecification(ExperimentSpecification):
    """Generic run-once job: an experiment's shape without metric semantics."""

    kind: str = Kinds.JOB

    _TAKES = (Kinds.JOB, Kinds.BUILD)
    _KIND_MESSAGE = "Expected kind=job|build, got {kind!r}"


#: The port's built-in entrypoint of a service kind without a run section.
SERVICE_BUILTINS = {
    Kinds.TENSORBOARD: "polyaxon_tpu_torch.builtins.services:tensorboard",
    Kinds.NOTEBOOK: "polyaxon_tpu_torch.builtins.services:jupyter",
    Kinds.SERVICE: "polyaxon_tpu_torch.builtins.services:lm_server",
}


@dataclass
class ServiceSpecification(BaseSpecification):
    """Long-running service (notebook / tensorboard / the LM server)."""

    kind: str = Kinds.NOTEBOOK
    run: Optional[RunConfig] = None
    port: int = 0  # 0 = auto-assign

    _KIND_KEYS = ("run", "port")
    _TAKES = (Kinds.NOTEBOOK, Kinds.TENSORBOARD, Kinds.SERVICE)
    _KIND_MESSAGE = "Expected kind=notebook|tensorboard|service, got {kind!r}"

    def _validate_kind(self, d: Dict[str, Any]) -> None:
        if d.get("run") is not None:
            self.run = RunConfig.from_dict(d["run"])
        self.port = as_int(d.get("port", 0), "port")

    def resolved_run(self) -> RunConfig:
        """Run section with declarations interpolated; without one, the
        kind's built-in entrypoint (see the module docstring)."""
        if self.run is None:
            entrypoint = SERVICE_BUILTINS.get(self.kind)
            if entrypoint is None:
                raise ValueError(f"Service spec {self.kind!r} has no run section")
            return RunConfig(entrypoint=entrypoint)
        data = {"cmd": self.run.cmd, "entrypoint": self.run.entrypoint,
                "kwargs": copy.deepcopy(self.run.kwargs)}
        return RunConfig.from_dict(interpolate(data, self.declarations))


@dataclass
class GroupSpecification(BaseSpecification):
    """An hptuning sweep over an experiment template; the search tasks
    materialise each trial with :meth:`get_experiment_spec`."""

    kind: str = Kinds.GROUP
    run: Optional[RunConfig] = None
    hptuning: Optional[HPTuningConfig] = None

    _KIND_KEYS = ("run", "hptuning")
    _TAKES = (Kinds.GROUP,)
    _KIND_MESSAGE = "Expected kind=group, got {kind!r}"

    def _validate_kind(self, d: Dict[str, Any]) -> None:
        for name in self._KIND_KEYS:
            if name not in d:
                raise ValueError(f"{name}: Field required")
        self.run = RunConfig.from_dict(d["run"])
        self.hptuning = HPTuningConfig.from_dict(d["hptuning"])

    def get_experiment_spec(self, matrix_declaration: Dict[str, Any]) -> ExperimentSpecification:
        """Materialize one trial: group spec minus hptuning, declarations
        merged with the suggestion (suggestion wins)."""
        data = self.to_dict()
        del data["hptuning"]
        data["kind"] = Kinds.EXPERIMENT
        data["declarations"] = {**copy.deepcopy(self.declarations), **matrix_declaration}
        return ExperimentSpecification.from_dict(data)

    @property
    def matrix_space(self) -> Optional[int]:
        """Grid cardinality, None if any param is a continuous distribution."""
        total = 1
        for m in self.hptuning.matrix.values():
            n = m.length
            if n is None:
                return None
            total *= n
        return total


@dataclass
class PipelineSpecification(BaseSpecification):
    """DAG-of-operations spec: ``ops`` is a list of {name, run sections,
    dependencies: [names]}."""

    kind: str = Kinds.PIPELINE
    ops: List[Dict[str, Any]] = field(default_factory=list)
    concurrency: Optional[int] = None

    _KIND_KEYS = ("ops", "concurrency")
    _TAKES = (Kinds.PIPELINE,)
    _KIND_MESSAGE = "Expected kind=pipeline, got {kind!r}"

    def _validate_kind(self, d: Dict[str, Any]) -> None:
        ops = d.get("ops", [])
        if not isinstance(ops, (list, tuple)):
            raise ValueError("ops: Input should be a valid list")
        ops = [as_dict(op, f"ops.{i}") for i, op in enumerate(ops)]
        names = [op.get("name") for op in ops]
        if any(n is None for n in names):
            raise ValueError("every pipeline op needs a name")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate op names in pipeline: {names}")
        known = set(names)
        for op in ops:
            for dep in op.get("dependencies", []):
                if dep not in known:
                    raise ValueError(f"op {op['name']!r} depends on unknown op {dep!r}")
        self.ops = ops
        self.concurrency = optional(as_int)(d.get("concurrency"), "concurrency")


_KIND_TO_SPEC = {
    Kinds.EXPERIMENT: ExperimentSpecification,
    Kinds.GROUP: GroupSpecification,
    Kinds.JOB: JobSpecification,
    Kinds.BUILD: JobSpecification,
    Kinds.NOTEBOOK: ServiceSpecification,
    Kinds.TENSORBOARD: ServiceSpecification,
    Kinds.SERVICE: ServiceSpecification,
    Kinds.PIPELINE: PipelineSpecification,
}


def specification_for_kind(kind: str) -> type:
    try:
        return _KIND_TO_SPEC[kind]
    except KeyError:
        raise SchemaError(f"Unknown kind {kind!r}; one of {Kinds.VALUES}") from None
