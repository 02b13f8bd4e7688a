"""Apply parsed query conditions to registry runs, the port's copy of
``polyaxon_tpu/query/builder.py``: :func:`apply_query` filters the port
registry's runs in process (plain columns and the JSON ``last_metric`` /
``declarations`` / ``tags`` payloads alike), :func:`compile_to_sql` pushes
the conditions on plain columns down to WHERE fragments and leaves the rest
residual, and :func:`filters_archived` tells a listing surface that a query
takes over the archived dimension.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence

from polyaxon_tpu_torch.db.registry import Run
from polyaxon_tpu_torch.query.parser import Condition, QueryError, parse_query

#: plain run attributes addressable in queries
_FIELDS = {
    "id", "uuid", "kind", "name", "project", "status", "group_id",
    "pipeline_id", "original_id", "restarts", "created_at", "started_at",
    "finished_at",
}


def _validate_archived(cond: Condition) -> None:
    """`archived:` is a derived boolean; both query paths (SQL pushdown
    and in-process) must reject the same malformed shapes — a condition
    that 400s on one surface must not silently 'work' on another."""
    if cond.op != "eq" or not isinstance(cond.value, bool):
        raise QueryError("archived expects true or false")


def _resolve(run: Run, field: str) -> Any:
    if field == "archived":
        # Derived boolean over archived_at — `archived:true` surfaces the
        # reference's archived-manager split inside the query DSL.
        return run.archived_at is not None
    if field in _FIELDS:
        return getattr(run, field)
    if field.startswith("metric."):
        return run.last_metric.get(field.split(".", 1)[1])
    if field.startswith("declarations.") or field.startswith("params."):
        return run.spec_data.get("declarations", {}).get(field.split(".", 1)[1])
    if field == "tags":
        return run.tags
    raise QueryError(
        f"Unknown query field {field!r} (plain fields: "
        f"{sorted(_FIELDS) + ['archived']}; JSON fields: metric.<name>, "
        "declarations.<name>, tags)"
    )


def _matches(run: Run, cond: Condition) -> bool:
    actual = _resolve(run, cond.field)
    if cond.field == "tags":
        values = cond.value if isinstance(cond.value, list) else [cond.value]
        result = any(v in (actual or []) for v in values)
    elif actual is None:
        result = False
    elif cond.op == "eq":
        result = actual == cond.value
    elif cond.op == "in":
        result = actual in cond.value
    elif cond.op == "range":
        lo, hi = cond.value
        try:
            result = lo <= actual <= hi
        except TypeError:
            result = False
    else:
        try:
            result = {
                "gt": actual > cond.value,
                "gte": actual >= cond.value,
                "lt": actual < cond.value,
                "lte": actual <= cond.value,
            }[cond.op]
        except TypeError:
            result = False
    return not result if cond.negated else result


def filters_archived(conditions: Sequence[Condition]) -> bool:
    """Does this query take over the archived dimension?  Listing
    surfaces default to live-only (``list_runs(archived=False)``); a
    query filtering on ``archived:`` must see BOTH populations or its
    clause contradicts the default and silently returns nothing."""
    return any(c.field == "archived" for c in conditions)


def apply_query(
    runs: Iterable[Run],
    query: Optional[str] = None,
    conditions: Optional[Sequence[Condition]] = None,
) -> List[Run]:
    """Filter runs by a query string (AND of all its conditions)."""
    conds = list(conditions or []) or parse_query(query)
    # Validate ONCE up front, not per-run: a malformed condition must
    # error identically on an empty result set and a full one (and match
    # compile_to_sql's validation exactly).
    for c in conds:
        if c.field == "archived":
            _validate_archived(c)
    return [r for r in runs if all(_matches(r, c) for c in conds)]


def compile_to_sql(
    conditions: Sequence[Condition],
) -> tuple:
    """Split conditions into (sql_clauses, params, residual_conditions).

    Conditions on real ``runs`` columns compile to WHERE fragments (the
    reference's queryset pushdown); JSON-payload fields (``metric.*``,
    ``declarations.*``, ``tags``) stay residual for the in-process filter.
    NULL handling mirrors the Python semantics exactly: a NULL column never
    matches a positive condition and always matches a negated one.
    """
    clauses: List[str] = []
    params: List[Any] = []
    residual: List[Condition] = []
    for cond in conditions:
        if cond.field == "archived":
            # Derived boolean: pushes down as a NULL check on archived_at.
            _validate_archived(cond)
            want = cond.value != cond.negated
            clauses.append(
                "archived_at IS NOT NULL" if want else "archived_at IS NULL"
            )
            continue
        if cond.field not in _FIELDS:
            if not (
                cond.field.startswith(("metric.", "declarations.", "params."))
                or cond.field == "tags"
            ):
                # Same validation the in-process path gives — unknown
                # fields must 400, not silently match everything.
                raise QueryError(
                    f"Unknown query field {cond.field!r} (plain fields: "
                    f"{sorted(_FIELDS) + ['archived']}; JSON fields: "
                    "metric.<name>, declarations.<name>, tags)"
                )
            residual.append(cond)
            continue
        col = cond.field  # _FIELDS is a fixed allowlist — never user text
        if cond.op == "eq":
            frag, ps = f"{col} = ?", [cond.value]
        elif cond.op == "in":
            frag = f"{col} IN ({','.join('?' * len(cond.value))})"
            ps = list(cond.value)
        elif cond.op == "range":
            frag, ps = f"{col} BETWEEN ? AND ?", list(cond.value)
        elif cond.op in ("gt", "gte", "lt", "lte"):
            sym = {"gt": ">", "gte": ">=", "lt": "<", "lte": "<="}[cond.op]
            frag, ps = f"{col} {sym} ?", [cond.value]
        else:  # pragma: no cover - parser emits only the ops above
            residual.append(cond)
            continue
        if cond.negated:
            frag = f"(NOT ({frag}) OR {col} IS NULL)"
        clauses.append(frag)
        params.extend(ps)
    return clauses, params, residual
