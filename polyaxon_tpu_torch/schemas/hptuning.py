"""Hyperparameter-tuning section of a group spec, the port's copy of
``polyaxon_tpu/schemas/hptuning.py``: the target metric, early stopping,
the grid, random, hyperband and Bayesian-optimization configs, and
:class:`HPTuningConfig` (the matrix plus at most one search algorithm).

Dataclasses whose ``from_dict`` runs :mod:`.fields`' checks instead of the
reference's pydantic models; they accept and refuse the documents pydantic's
lax mode does: the ``ge``/``gt`` bounds, the lowered ``optimization``, the
``kernel`` (``matern|rbf``) and ``acquisition_function`` (``ucb|ei|poi``)
choices, unknown keys refused, and the section-wide rules (at most one
algorithm, a hyperband resource outside the matrix, bounded params under BO).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from polyaxon_tpu_torch.schemas.fields import (
    as_bool,
    as_dict,
    as_float,
    as_int,
    as_str,
    at_least,
    check_keys,
    drop_none,
    optional,
)
from polyaxon_tpu_torch.schemas.matrix import MatrixConfig


class Optimization:
    MAXIMIZE = "maximize"
    MINIMIZE = "minimize"
    VALUES = (MAXIMIZE, MINIMIZE)


class SearchAlgorithms:
    GRID = "grid"
    RANDOM = "random"
    HYPERBAND = "hyperband"
    BO = "bo"
    VALUES = (GRID, RANDOM, HYPERBAND, BO)


def _greater_than(value: float, bound: float, where: str) -> None:
    if not value > bound:
        raise ValueError(f"{where}: Input should be greater than {bound}")


def _required(d: Dict[str, Any], name: str, where: str) -> Any:
    if name not in d:
        raise ValueError(f"{where}.{name}: Field required")
    return d[name]


@dataclass
class SearchMetricConfig:
    """The target metric a search optimizes (e.g. loss / accuracy)."""

    name: str
    optimization: str = Optimization.MAXIMIZE

    @classmethod
    def from_dict(cls, data: Any, where: str = "metric") -> "SearchMetricConfig":
        d = check_keys(data, ("name", "optimization"), where)
        name = as_str(_required(d, "name", where), f"{where}.name")
        opt = as_str(d.get("optimization", Optimization.MAXIMIZE), f"{where}.optimization")
        opt = opt.lower()
        if opt not in Optimization.VALUES:
            raise ValueError(f"{where}.optimization: optimization must be one of "
                             f"{Optimization.VALUES}")
        return cls(name=name, optimization=opt)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "optimization": self.optimization}


@dataclass
class EarlyStoppingConfig:
    """Stop the whole sweep once a metric crosses a threshold."""

    metric: SearchMetricConfig
    value: float
    policy: str = "all"  # reserved for future policies

    @classmethod
    def from_dict(cls, data: Any, where: str = "early_stopping") -> "EarlyStoppingConfig":
        d = check_keys(data, ("metric", "value", "policy"), where)
        return cls(
            metric=SearchMetricConfig.from_dict(_required(d, "metric", where), f"{where}.metric"),
            value=as_float(_required(d, "value", where), f"{where}.value"),
            policy=as_str(d.get("policy", "all"), f"{where}.policy"),
        )

    def passed(self, value: Optional[float]) -> bool:
        if value is None:
            return False
        if self.metric.optimization == Optimization.MAXIMIZE:
            return value >= self.value
        return value <= self.value

    def to_dict(self) -> Dict[str, Any]:
        return {"metric": self.metric.to_dict(), "value": self.value, "policy": self.policy}


@dataclass
class GridSearchConfig:
    n_experiments: Optional[int] = None

    @classmethod
    def from_dict(cls, data: Any, where: str = "grid_search") -> "GridSearchConfig":
        d = check_keys(data, ("n_experiments",), where)
        n = optional(as_int)(d.get("n_experiments"), f"{where}.n_experiments")
        at_least(n, 1, f"{where}.n_experiments")
        return cls(n_experiments=n)

    def to_dict(self) -> Dict[str, Any]:
        return drop_none({"n_experiments": self.n_experiments})


@dataclass
class RandomSearchConfig:
    n_experiments: int
    seed: Optional[int] = None

    @classmethod
    def from_dict(cls, data: Any, where: str = "random_search") -> "RandomSearchConfig":
        d = check_keys(data, ("n_experiments", "seed"), where)
        n = as_int(_required(d, "n_experiments", where), f"{where}.n_experiments")
        at_least(n, 1, f"{where}.n_experiments")
        return cls(n_experiments=n, seed=optional(as_int)(d.get("seed"), f"{where}.seed"))

    def to_dict(self) -> Dict[str, Any]:
        return drop_none({"n_experiments": self.n_experiments, "seed": self.seed})


@dataclass
class HyperbandConfig:
    """Hyperband bracket config: ``max_iterations`` is R (the most resource
    a trial gets), ``eta`` the down-sampling rate, ``resource`` names the
    budget hyperparameter injected into suggestions."""

    max_iterations: int
    eta: float
    resource: SearchMetricConfig  # name + (ab)used: optimization unused
    metric: SearchMetricConfig
    resume: bool = False
    seed: Optional[int] = None

    @classmethod
    def from_dict(cls, data: Any, where: str = "hyperband") -> "HyperbandConfig":
        d = check_keys(data, ("max_iterations", "eta", "resource", "metric", "resume", "seed"),
                       where)
        max_iterations = as_int(_required(d, "max_iterations", where), f"{where}.max_iterations")
        at_least(max_iterations, 1, f"{where}.max_iterations")
        eta = as_float(_required(d, "eta", where), f"{where}.eta")
        _greater_than(eta, 1, f"{where}.eta")
        return cls(
            max_iterations=max_iterations,
            eta=eta,
            resource=SearchMetricConfig.from_dict(_required(d, "resource", where),
                              f"{where}.resource"),
            metric=SearchMetricConfig.from_dict(_required(d, "metric", where), f"{where}.metric"),
            resume=as_bool(d.get("resume", False), f"{where}.resume"),
            seed=optional(as_int)(d.get("seed"), f"{where}.seed"),
        )

    def to_dict(self) -> Dict[str, Any]:
        return drop_none({"max_iterations": self.max_iterations, "eta": self.eta,
                          "resource": self.resource, "metric": self.metric,
                          "resume": self.resume, "seed": self.seed})


@dataclass
class GaussianProcessConfig:
    kernel: str = "matern"  # matern | rbf
    length_scale: float = 1.0
    nu: float = 1.5
    n_restarts_optimizer: int = 0

    @classmethod
    def from_dict(cls, data: Any, where: str = "gaussian_process") -> "GaussianProcessConfig":
        d = check_keys(data, ("kernel", "length_scale", "nu", "n_restarts_optimizer"), where)
        kernel = as_str(d.get("kernel", "matern"), f"{where}.kernel")
        if kernel not in ("matern", "rbf"):
            raise ValueError(f"{where}.kernel: kernel must be 'matern' or 'rbf'")
        return cls(
            kernel=kernel,
            length_scale=as_float(d.get("length_scale", 1.0), f"{where}.length_scale"),
            nu=as_float(d.get("nu", 1.5), f"{where}.nu"),
            n_restarts_optimizer=as_int(d.get("n_restarts_optimizer", 0),
                                        f"{where}.n_restarts_optimizer"),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"kernel": self.kernel, "length_scale": self.length_scale, "nu": self.nu,
                "n_restarts_optimizer": self.n_restarts_optimizer}


@dataclass
class UtilityFunctionConfig:
    """Acquisition function config (UCB kappa / EI-POI eps)."""

    acquisition_function: str = "ucb"  # ucb | ei | poi
    kappa: float = 2.576
    eps: float = 0.0
    gaussian_process: GaussianProcessConfig = field(default_factory=GaussianProcessConfig)
    n_warmup: int = 200
    n_iter: int = 10

    @classmethod
    def from_dict(cls, data: Any, where: str = "utility_function") -> "UtilityFunctionConfig":
        d = check_keys(data, ("acquisition_function", "kappa", "eps", "gaussian_process",
                              "n_warmup", "n_iter"), where)
        acq = as_str(d.get("acquisition_function", "ucb"), f"{where}.acquisition_function")
        if acq not in ("ucb", "ei", "poi"):
            raise ValueError(f"{where}.acquisition_function: acquisition_function must be "
                             "ucb|ei|poi")
        return cls(
            acquisition_function=acq,
            kappa=as_float(d.get("kappa", 2.576), f"{where}.kappa"),
            eps=as_float(d.get("eps", 0.0), f"{where}.eps"),
            gaussian_process=(GaussianProcessConfig() if "gaussian_process" not in d else
                              GaussianProcessConfig.from_dict(d["gaussian_process"],
                                                              f"{where}.gaussian_process")),
            n_warmup=as_int(d.get("n_warmup", 200), f"{where}.n_warmup"),
            n_iter=as_int(d.get("n_iter", 10), f"{where}.n_iter"),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"acquisition_function": self.acquisition_function, "kappa": self.kappa,
                "eps": self.eps, "gaussian_process": self.gaussian_process.to_dict(),
                "n_warmup": self.n_warmup, "n_iter": self.n_iter}


@dataclass
class BOConfig:
    """Bayesian-optimization config."""

    n_initial_trials: int
    n_iterations: int
    metric: SearchMetricConfig
    utility_function: UtilityFunctionConfig = field(default_factory=UtilityFunctionConfig)
    seed: Optional[int] = None

    @classmethod
    def from_dict(cls, data: Any, where: str = "bo") -> "BOConfig":
        d = check_keys(data, ("n_initial_trials", "n_iterations", "metric", "utility_function",
                              "seed"), where)
        counts = {}
        for name in ("n_initial_trials", "n_iterations"):
            counts[name] = as_int(_required(d, name, where), f"{where}.{name}")
            at_least(counts[name], 1, f"{where}.{name}")
        return cls(
            metric=SearchMetricConfig.from_dict(_required(d, "metric", where), f"{where}.metric"),
            utility_function=(UtilityFunctionConfig() if "utility_function" not in d else
                              UtilityFunctionConfig.from_dict(d["utility_function"],
                                                              f"{where}.utility_function")),
            seed=optional(as_int)(d.get("seed"), f"{where}.seed"),
            **counts,
        )

    def to_dict(self) -> Dict[str, Any]:
        return drop_none({"n_initial_trials": self.n_initial_trials,
                          "n_iterations": self.n_iterations, "metric": self.metric,
                          "utility_function": self.utility_function, "seed": self.seed})


_ALGORITHMS = {
    "grid_search": GridSearchConfig,
    "random_search": RandomSearchConfig,
    "hyperband": HyperbandConfig,
    "bo": BOConfig,
}


@dataclass
class HPTuningConfig:
    """The ``hptuning`` section: matrix + at most one search algorithm."""

    matrix: Dict[str, MatrixConfig]
    concurrency: int = 1
    grid_search: Optional[GridSearchConfig] = None
    random_search: Optional[RandomSearchConfig] = None
    hyperband: Optional[HyperbandConfig] = None
    bo: Optional[BOConfig] = None
    early_stopping: List[EarlyStoppingConfig] = field(default_factory=list)
    seed: Optional[int] = None

    @classmethod
    def from_dict(cls, data: Any, where: str = "hptuning") -> "HPTuningConfig":
        d = check_keys(data, ("matrix", "concurrency", "early_stopping", "seed")
                       + tuple(_ALGORITHMS), where)
        matrix = _required(d, "matrix", where)
        if not isinstance(matrix, dict) or not matrix:
            raise ValueError(f"{where}.matrix: matrix must be a non-empty mapping")
        matrix = {name: MatrixConfig.from_dict(entry)
                  for name, entry in as_dict(matrix, f"{where}.matrix").items()}
        concurrency = as_int(d.get("concurrency", 1), f"{where}.concurrency")
        at_least(concurrency, 1, f"{where}.concurrency")
        stopping = d.get("early_stopping", [])
        if not isinstance(stopping, (list, tuple)):
            raise ValueError(f"{where}.early_stopping: Input should be a valid list")
        out = cls(
            matrix=matrix,
            concurrency=concurrency,
            early_stopping=[EarlyStoppingConfig.from_dict(es, f"{where}.early_stopping.{i}")
                            for i, es in enumerate(stopping)],
            seed=optional(as_int)(d.get("seed"), f"{where}.seed"),
            **{name: None if d.get(name) is None else algo.from_dict(d[name], f"{where}.{name}")
               for name, algo in _ALGORITHMS.items()},
        )
        out._check_algorithm()
        return out

    def _check_algorithm(self) -> None:
        set_algos = [a for a in _ALGORITHMS if getattr(self, a) is not None]
        if len(set_algos) > 1:
            raise ValueError(f"At most one search algorithm allowed, got {set_algos}")
        if self.hyperband is not None:
            resource = self.hyperband.resource.name
            if resource in self.matrix:
                raise ValueError(
                    f"Hyperband resource param {resource!r} must not appear in matrix"
                )
        if self.bo is not None:
            for name, m in self.matrix.items():
                if m.is_continuous and m.min is None:
                    raise ValueError(
                        f"BO requires bounded params; {name!r} ({m.op}) is unbounded"
                    )

    @property
    def search_algorithm(self) -> str:
        if self.grid_search is not None:
            return SearchAlgorithms.GRID
        if self.random_search is not None:
            return SearchAlgorithms.RANDOM
        if self.hyperband is not None:
            return SearchAlgorithms.HYPERBAND
        if self.bo is not None:
            return SearchAlgorithms.BO
        return SearchAlgorithms.GRID

    def to_dict(self) -> Dict[str, Any]:
        data = drop_none({"concurrency": self.concurrency,
                          **{name: getattr(self, name) for name in _ALGORITHMS},
                          "early_stopping": [es.to_dict() for es in self.early_stopping],
                          "seed": self.seed})
        data["matrix"] = {k: m.to_dict() for k, m in self.matrix.items()}
        return data
