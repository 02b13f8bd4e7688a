"""Search/filter query DSL parser, the port's copy of
``polyaxon_tpu/query/parser.py``:

- comma-separated conditions: ``status:running, metric.loss:<0.5``
- value-in: ``status:running|starting``
- negation: ``status:~failed``
- comparison: ``metric.acc:>0.9``, ``created_at:>=2020-01-01``
- range: ``id:1..10``
- nested fields: ``metric.<name>``, ``declarations.<name>`` (JSON payloads)
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from datetime import datetime
from typing import Any, List, Optional, Tuple

from polyaxon_tpu_torch.exceptions import PolyaxonTPUError


class QueryError(PolyaxonTPUError):
    pass


#: op ∈ {"eq", "in", "gt", "gte", "lt", "lte", "range"}
@dataclass(frozen=True)
class Condition:
    field: str
    op: str
    value: Any
    negated: bool = False


_DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}([T ].+)?$")


def _coerce(raw: str) -> Any:
    raw = raw.strip()
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    lowered = raw.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if _DATE_RE.match(raw):
        # Date comparisons target epoch-float columns (created_at, ...).
        try:
            return datetime.fromisoformat(raw).timestamp()
        except ValueError:
            pass
    return raw


def _parse_value(field: str, raw: str) -> Tuple[str, Any]:
    raw = raw.strip()
    if not raw:
        raise QueryError(f"Empty value for field {field!r}")
    if ".." in raw:
        lo, hi = raw.split("..", 1)
        return "range", (_coerce(lo), _coerce(hi))
    for prefix, op in (
        (">=", "gte"),
        ("<=", "lte"),
        (">", "gt"),
        ("<", "lt"),
    ):
        if raw.startswith(prefix):
            return op, _coerce(raw[len(prefix):])
    if "|" in raw:
        return "in", [_coerce(v) for v in raw.split("|") if v.strip()]
    return "eq", _coerce(raw)


def parse_query(query: Optional[str]) -> List[Condition]:
    """``"a:1, b:~x|y"`` → conditions. Empty/None → no conditions."""
    if not query or not query.strip():
        return []
    conditions = []
    for part in query.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise QueryError(f"Condition {part!r} is not of the form field:value")
        field, raw = part.split(":", 1)
        field = field.strip()
        raw = raw.strip()
        negated = raw.startswith("~")
        if negated:
            raw = raw[1:]
        op, value = _parse_value(field, raw)
        conditions.append(Condition(field=field, op=op, value=value, negated=negated))
    return conditions
