"""The port's copy of ``polyaxon_tpu.schemas``: the spec sections, the
matrix and hptuning sections of a group, the typed specifications of every
kind, and the control plane's spec loader (dataclasses with explicit checks,
no pydantic)."""

from polyaxon_tpu_torch.schemas.environments import (
    ACCELERATOR_CATALOG,
    STRATEGIES,
    EnvironmentConfig,
    MeshConfig,
    RestartPolicyConfig,
    TopologyConfig,
)
from polyaxon_tpu_torch.schemas.hptuning import (
    BOConfig,
    EarlyStoppingConfig,
    GridSearchConfig,
    HPTuningConfig,
    HyperbandConfig,
    RandomSearchConfig,
    SearchMetricConfig,
)
from polyaxon_tpu_torch.schemas.matrix import MatrixConfig
from polyaxon_tpu_torch.schemas.polyaxonfile import PolyaxonFile
from polyaxon_tpu_torch.schemas.run import BuildConfig, RunConfig
from polyaxon_tpu_torch.schemas.specifications import (
    BaseSpecification,
    ExperimentSpecification,
    GroupSpecification,
    JobSpecification,
    Kinds,
    PipelineSpecification,
    ServiceSpecification,
    interpolate,
    specification_for_kind,
)

__all__ = [
    "ACCELERATOR_CATALOG", "STRATEGIES", "EnvironmentConfig", "MeshConfig",
    "RestartPolicyConfig", "TopologyConfig", "BuildConfig", "RunConfig",
    "MatrixConfig", "HPTuningConfig", "GridSearchConfig", "RandomSearchConfig",
    "HyperbandConfig", "BOConfig", "EarlyStoppingConfig", "SearchMetricConfig",
    "BaseSpecification", "ExperimentSpecification", "GroupSpecification",
    "JobSpecification", "Kinds", "PipelineSpecification", "ServiceSpecification",
    "interpolate", "specification_for_kind", "PolyaxonFile",
]
