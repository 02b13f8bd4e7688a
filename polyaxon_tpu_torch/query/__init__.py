"""The runs query DSL, the port's copy of ``polyaxon_tpu.query``."""

from polyaxon_tpu_torch.query.builder import apply_query, compile_to_sql, filters_archived
from polyaxon_tpu_torch.query.parser import Condition, QueryError, parse_query

__all__ = ["Condition", "QueryError", "apply_query", "compile_to_sql", "filters_archived",
           "parse_query"]
