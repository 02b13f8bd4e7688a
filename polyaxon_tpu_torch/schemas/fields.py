"""Field checks for the port's spec sections: the coercions pydantic's lax
mode applies to the reference's models, written out.

The reference validates its spec sections with pydantic models
(``polyaxon_tpu/schemas/``); the port has no pydantic, so each section is a
dataclass whose ``from_dict`` runs these checks.  They take what pydantic
takes: an ``int`` field an int, a bool, an integral float or a string of
digits; a ``float`` field any number or a numeric string; a ``bool`` field
a bool, 0 or 1, or one of pydantic's words (``yes``, ``off``, ...); a ``str``
field only a string.  Unknown keys are refused (the reference's
``extra="forbid"``).  Every failure is a ``ValueError`` naming the field by
its dotted path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional


def check_keys(data: Any, allowed: Iterable[str], where: str) -> Dict[str, Any]:
    """``data`` as a dict, refusing non-mappings and keys outside ``allowed``."""
    if not isinstance(data, Mapping):
        raise ValueError(f"{where}: Input should be a valid dictionary, got {type(data).__name__}")
    extra = sorted(set(data) - set(allowed))
    if extra:
        raise ValueError(f"{where}.{extra[0]}: Extra inputs are not permitted")
    return dict(data)


def as_int(v: Any, where: str) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if v.is_integer():
            return int(v)
        raise ValueError(f"{where}: Input should be a valid integer, got a number with a "
                         "fractional part")
    if isinstance(v, str):
        try:
            return int(v.strip())
        except ValueError:
            pass
        raise ValueError(f"{where}: Input should be a valid integer, unable to parse string "
                         "as an integer")
    raise ValueError(f"{where}: Input should be a valid integer")


def as_float(v: Any, where: str) -> float:
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            pass
    raise ValueError(f"{where}: Input should be a valid number")


_TRUE = ("1", "on", "t", "true", "y", "yes")
_FALSE = ("0", "off", "f", "false", "n", "no")


def as_bool(v: Any, where: str) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _TRUE + _FALSE:
        return v.lower() in _TRUE
    raise ValueError(f"{where}: Input should be a valid boolean")


def as_str(v: Any, where: str) -> str:
    if isinstance(v, str):
        return v
    raise ValueError(f"{where}: Input should be a valid string")


def as_dict(v: Any, where: str) -> Dict[str, Any]:
    if isinstance(v, Mapping):
        return {as_str(k, f"{where}.[key]"): x for k, x in v.items()}
    raise ValueError(f"{where}: Input should be a valid dictionary")


def as_str_dict(v: Any, where: str) -> Dict[str, str]:
    return {k: as_str(x, f"{where}.{k}") for k, x in as_dict(v, where).items()}


def as_int_dict(v: Any, where: str) -> Dict[str, int]:
    return {k: as_int(x, f"{where}.{k}") for k, x in as_dict(v, where).items()}


def as_str_list(v: Any, where: str) -> List[str]:
    if isinstance(v, (list, tuple)):
        return [as_str(x, f"{where}.{i}") for i, x in enumerate(v)]
    raise ValueError(f"{where}: Input should be a valid list")


def optional(check: Callable[[Any, str], Any]) -> Callable[[Any, str], Any]:
    """``check`` that lets None through."""

    def run(v: Any, where: str) -> Any:
        return None if v is None else check(v, where)

    return run


def at_least(value: Optional[float], bound: float, where: str) -> None:
    if value is not None and value < bound:
        raise ValueError(f"{where}: Input should be greater than or equal to {bound}")


def drop_none(data: Dict[str, Any]) -> Dict[str, Any]:
    """A section's dict without its None fields (``model_dump(exclude_none=True)``)."""
    out = {}
    for k, v in data.items():
        if v is None:
            continue
        out[k] = v.to_dict() if hasattr(v, "to_dict") else v
    return out
