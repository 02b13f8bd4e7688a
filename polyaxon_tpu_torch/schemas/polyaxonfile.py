"""Polyaxonfile loading, the port's copy of
``polyaxon_tpu/schemas/polyaxonfile.py``: a YAML or JSON document, a path
or a dict, to a typed specification.

A document with an ``hptuning`` (or legacy top-level ``matrix``) section is
a group, as in the reference's loader.  ``yaml`` is imported only for text
that is not JSON: a dict or a JSON spec never needs PyYAML, which the card's
machine may lack.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Union

from polyaxon_tpu_torch.exceptions import SchemaError
from polyaxon_tpu_torch.schemas.specifications import (
    BaseSpecification,
    Kinds,
    specification_for_kind,
)


class PolyaxonFile:
    """Load + validate a spec document from a path, string, or dict."""

    def __init__(self, data: Dict[str, Any]) -> None:
        if not isinstance(data, dict):
            raise SchemaError(f"Spec document must be a mapping, got {type(data)}")
        self._data = self._normalize(dict(data))
        spec_cls = specification_for_kind(self._data["kind"])
        self.specification: BaseSpecification = spec_cls.from_dict(self._data)

    @staticmethod
    def _normalize(data: Dict[str, Any]) -> Dict[str, Any]:
        if "matrix" in data and "hptuning" not in data:
            # legacy top-level matrix section → hptuning.matrix
            data["hptuning"] = {"matrix": data.pop("matrix")}
        if "kind" not in data:
            data["kind"] = Kinds.GROUP if "hptuning" in data else Kinds.EXPERIMENT
        if data.get("kind") == Kinds.EXPERIMENT and "hptuning" in data:
            data["kind"] = Kinds.GROUP
        return data

    @classmethod
    def from_path(cls, path: Union[str, os.PathLike]) -> "PolyaxonFile":
        with open(path, "r", encoding="utf-8") as f:
            raw = f.read()
        return cls.from_str(raw)

    @classmethod
    def from_str(cls, raw: str) -> "PolyaxonFile":
        raw = raw.strip()
        if not raw:
            raise SchemaError("Empty spec document")
        if raw.startswith("{"):
            try:
                return cls(json.loads(raw))
            except json.JSONDecodeError as e:
                raise SchemaError(f"Invalid JSON spec: {e}") from e
        import yaml

        try:
            data = yaml.safe_load(raw)
        except yaml.YAMLError as e:
            raise SchemaError(f"Invalid YAML spec: {e}") from e
        return cls(data)

    @classmethod
    def load(cls, source: Union[str, os.PathLike, Dict[str, Any]]) -> "PolyaxonFile":
        if isinstance(source, dict):
            return cls(source)
        if isinstance(source, (str, os.PathLike)) and os.path.exists(str(source)):
            return cls.from_path(source)
        if isinstance(source, str):
            return cls.from_str(source)
        raise SchemaError(f"Cannot load spec from {source!r}")

    @property
    def kind(self) -> str:
        return self.specification.kind

    def to_dict(self) -> Dict[str, Any]:
        return self.specification.to_dict()
