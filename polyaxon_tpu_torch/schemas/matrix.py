"""Hyperparameter matrix ops, the port's copy of
``polyaxon_tpu/schemas/matrix.py``: one hyperparameter's search space.

Grid-able ops: ``values``, ``range``, ``linspace``, ``logspace``,
``geomspace``; distributions: ``pvalues``, ``uniform``, ``quniform``,
``loguniform``, ``qloguniform``, ``normal``, ``qnormal``, ``lognormal``,
``qlognormal``.

Range-like arguments accept ``[start, stop, step_or_num]`` lists,
``"start:stop:step_or_num"`` strings, or ``{start:, stop:, step:|num:}``
dicts.  Sampling makes the reference's numpy ``Generator`` calls in the
reference's order, so a seed gives the same values bit for bit.  Errors are
the port's :class:`~polyaxon_tpu_torch.exceptions.SchemaError`.
"""

from __future__ import annotations

import numbers
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from polyaxon_tpu_torch.exceptions import SchemaError

GRID_OPS = ("values", "range", "linspace", "logspace", "geomspace")
DIST_OPS = (
    "pvalues",
    "uniform",
    "quniform",
    "loguniform",
    "qloguniform",
    "normal",
    "qnormal",
    "lognormal",
    "qlognormal",
)
ALL_OPS = GRID_OPS + DIST_OPS


def _parse_3(value: Any, keys: Sequence[str]) -> List[float]:
    """Normalize range-ish params to [a, b, c] floats."""
    if isinstance(value, str):
        parts = value.split(":")
    elif isinstance(value, dict):
        missing = [k for k in keys if k not in value]
        if missing:
            raise SchemaError(f"Missing keys {missing} in {value!r}")
        parts = [value[k] for k in keys]
    elif isinstance(value, (list, tuple)):
        parts = list(value)
    else:
        raise SchemaError(f"Cannot parse range argument {value!r}")
    if len(parts) != 3:
        raise SchemaError(f"Expected 3 elements (got {len(parts)}): {value!r}")
    try:
        return [float(p) for p in parts]
    except (TypeError, ValueError) as e:
        raise SchemaError(f"Non-numeric range argument {value!r}") from e


def _parse_2(value: Any, keys: Sequence[str] = ("low", "high")) -> List[float]:
    if isinstance(value, str):
        parts = value.split(":")
    elif isinstance(value, dict):
        parts = [value[k] for k in keys if k in value]
    elif isinstance(value, (list, tuple)):
        parts = list(value)
    else:
        raise SchemaError(f"Cannot parse argument {value!r}")
    if len(parts) != 2:
        raise SchemaError(f"Expected 2 elements (got {len(parts)}): {value!r}")
    try:
        return [float(p) for p in parts]
    except (TypeError, ValueError) as e:
        raise SchemaError(f"Non-numeric argument {value!r}") from e


def _quantize(sample: float, q: float) -> float:
    return float(np.round(sample / q) * q)


class MatrixConfig:
    """One hyperparameter's search space: exactly one op + its argument."""

    def __init__(self, op: str, params: Any) -> None:
        if op not in ALL_OPS:
            raise SchemaError(f"Unknown matrix op {op!r}; one of {ALL_OPS}")
        self.op = op
        self.params = params
        self._validate()

    # -- construction --------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "MatrixConfig":
        if not isinstance(data, dict):
            raise SchemaError(f"Matrix entry must be a mapping, got {data!r}")
        ops = [k for k in data if k in ALL_OPS]
        if len(ops) != 1:
            raise SchemaError(
                f"Matrix entry must contain exactly one op from {ALL_OPS}, got {list(data)}"
            )
        return cls(ops[0], data[ops[0]])

    def to_dict(self) -> Dict[str, Any]:
        return {self.op: self.params}

    def _validate(self) -> None:
        op, p = self.op, self.params
        if op == "values":
            if not isinstance(p, (list, tuple)) or not p:
                raise SchemaError(f"`values` needs a non-empty list, got {p!r}")
        elif op == "pvalues":
            pairs = [tuple(v) for v in p]
            probs = [pr for _, pr in pairs]
            if not np.isclose(sum(probs), 1.0):
                raise SchemaError(f"`pvalues` probabilities must sum to 1, got {sum(probs)}")
            self.params = pairs
        elif op == "range":
            self.params = _parse_3(p, ("start", "stop", "step"))
            if self.params[2] == 0:
                raise SchemaError("`range` step must be non-zero")
        elif op in ("linspace", "logspace", "geomspace"):
            self.params = _parse_3(p, ("start", "stop", "num"))
            if int(self.params[2]) < 1:
                raise SchemaError(f"`{op}` num must be >= 1")
        elif op in ("uniform", "loguniform"):
            self.params = _parse_2(p)
        elif op in ("quniform", "qloguniform"):
            self.params = _parse_3(p, ("low", "high", "q"))
        elif op in ("normal", "lognormal"):
            self.params = _parse_2(p, ("loc", "scale"))
        elif op in ("qnormal", "qlognormal"):
            self.params = _parse_3(p, ("loc", "scale", "q"))

    # -- introspection -------------------------------------------------------
    @property
    def is_distribution(self) -> bool:
        return self.op in DIST_OPS

    @property
    def is_categorical(self) -> bool:
        if self.op == "pvalues":
            return True
        return self.op == "values" and any(
            not isinstance(v, numbers.Number) for v in self.params
        )

    @property
    def is_discrete(self) -> bool:
        return not self.is_distribution or self.op == "pvalues"

    @property
    def is_continuous(self) -> bool:
        return not self.is_discrete

    @property
    def is_uniform(self) -> bool:
        return self.op == "uniform"

    @property
    def min(self) -> Optional[float]:
        if self.is_categorical:
            return None
        if self.op == "values":
            return float(min(self.params))
        if self.op in ("range", "linspace", "logspace", "geomspace"):
            return float(min(self.to_numpy()))
        if self.op in ("uniform", "loguniform"):
            return self.params[0]
        if self.op in ("quniform", "qloguniform"):
            return self.params[0]
        return None  # unbounded (normal family)

    @property
    def max(self) -> Optional[float]:
        if self.is_categorical:
            return None
        if self.op == "values":
            return float(max(self.params))
        if self.op in ("range", "linspace", "logspace", "geomspace"):
            return float(max(self.to_numpy()))
        if self.op in ("uniform", "loguniform"):
            return self.params[1]
        if self.op in ("quniform", "qloguniform"):
            return self.params[1]
        return None

    @property
    def length(self) -> Optional[int]:
        """Cardinality for grid-able ops, None for continuous distributions."""
        if self.op in ("values", "pvalues"):
            return len(self.params)
        if self.op == "range":
            start, stop, step = self.params
            return len(np.arange(start, stop, step))
        if self.op in ("linspace", "logspace", "geomspace"):
            return int(self.params[2])
        return None

    # -- materialization -----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Enumerate grid values; raises for continuous distributions."""
        op, p = self.op, self.params
        if op == "values":
            return np.asarray(p)
        if op == "pvalues":
            return np.asarray([v for v, _ in p])
        if op == "range":
            return np.arange(p[0], p[1], p[2])
        if op == "linspace":
            return np.linspace(p[0], p[1], int(p[2]))
        if op == "logspace":
            return np.logspace(p[0], p[1], int(p[2]))
        if op == "geomspace":
            return np.geomspace(p[0], p[1], int(p[2]))
        raise SchemaError(f"Op {self.op!r} is a distribution; use sample()")

    def sample(self, rng: Optional[np.random.Generator] = None) -> Any:
        """Draw one value (grid ops sample uniformly from their grid)."""
        rng = rng if rng is not None else np.random.default_rng()
        op, p = self.op, self.params
        if op in GRID_OPS:
            vals = self.to_numpy()
            pick = vals[int(rng.integers(len(vals)))]
            return pick.item() if hasattr(pick, "item") else pick
        if op == "pvalues":
            idx = rng.choice(len(p), p=[pr for _, pr in p])
            return p[int(idx)][0]
        if op == "uniform":
            return float(rng.uniform(p[0], p[1]))
        if op == "quniform":
            return _quantize(rng.uniform(p[0], p[1]), p[2])
        if op == "loguniform":
            return float(np.exp(rng.uniform(np.log(p[0]), np.log(p[1]))))
        if op == "qloguniform":
            return _quantize(np.exp(rng.uniform(np.log(p[0]), np.log(p[1]))), p[2])
        if op == "normal":
            return float(rng.normal(p[0], p[1]))
        if op == "qnormal":
            return _quantize(rng.normal(p[0], p[1]), p[2])
        if op == "lognormal":
            return float(rng.lognormal(p[0], p[1]))
        if op == "qlognormal":
            return _quantize(rng.lognormal(p[0], p[1]), p[2])
        raise SchemaError(f"Unhandled op {op!r}")

    def __repr__(self) -> str:
        return f"MatrixConfig({self.op}={self.params!r})"

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, MatrixConfig)
            and self.op == other.op
            and self.params == other.params
        )
