"""Parallelism strategies as templates: the port's copy of the JAX package's.

Counterpart of ``polyaxon_tpu/parallel/templates.py``: every strategy the
spec DSL names (``environment.topology.strategy``) resolves against a mesh's
axis sizes to a :class:`StrategyTemplate`, the same fields and the same
errors as there, as data.  The rules map logical axes (``batch``, ``seq``,
``embed``, ...) to mesh axes; in the port they are read, not compiled:
``ddp`` and ``sp_ring`` run (:func:`polyaxon_tpu_torch.models.transformer.
forward`, :func:`polyaxon_tpu_torch.runtime.train.build_train_step`), and
every other strategy resolves here but raises there (ROADMAP item 7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple, Union

#: logical axis name -> mesh axis (str), tuple of mesh axes, or None (replicate)
AxisRules = Mapping[str, Union[str, Tuple[str, ...], None]]

#: Mesh axes over which the *batch* may be sharded (data-like axes).
DATA_AXES = ("replica", "data", "fsdp")

#: The strategies the port's forward and train step run; the others
#: resolve here and raise there (ROADMAP item 7).
PORTED_STRATEGIES = ("ddp", "sp_ring")


class RuntimeLayerError(Exception):
    """Mesh, strategy or runtime setup failed (the JAX package's error of the
    same name, kept apart so the port imports nothing of that package)."""


def check_ported(template: Optional["StrategyTemplate"]) -> None:
    """Raise unless ``template`` is None or one of :data:`PORTED_STRATEGIES`."""
    if template is not None and template.name not in PORTED_STRATEGIES:
        raise NotImplementedError(
            f"strategy {template.name!r} is not ported yet; ddp and sp_ring are "
            "(ROADMAP item 7: multi-process and parallelism)"
        )


@dataclass(frozen=True)
class StrategyTemplate:
    """Everything the runtime needs to apply one parallelism strategy."""

    name: str
    #: logical axis -> mesh axis (or tuple / None) for params AND activations
    rules: Dict[str, Any]
    #: mesh axes sharding the global-batch dimension
    batch_axes: Tuple[str, ...]
    #: attention runs the ring over this mesh axis (sp_ring)
    ring_axis: Optional[str] = None
    #: Ulysses sequence axis (all-to-all attention; not ported)
    ulysses_axis: Optional[str] = None
    #: layers are pipeline stages over this mesh axis (pp; not ported)
    pipeline_axis: Optional[str] = None
    #: microbatch count for the pipeline schedule
    num_microbatches: int = 1
    #: the pipeline is manual over ``pipeline_axis`` only (dp×tp×pp)
    pipeline_composed: bool = False
    options: Dict[str, Any] = field(default_factory=dict)

    def batch_spec(self) -> Tuple[str, ...]:
        """The mesh axes the batch dimension is split over, as a plain tuple
        (the JAX template returns a ``PartitionSpec`` of the same axes)."""
        return tuple(self.batch_axes)


def _data_axes(mesh_axes: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh_axes and mesh_axes[a] > 1)


def template_for(
    strategy: str,
    mesh_axes: Dict[str, int],
    options: Optional[Dict[str, Any]] = None,
) -> StrategyTemplate:
    """Resolve a named strategy against a mesh's axis sizes."""
    options = dict(options or {})
    data = _data_axes(mesh_axes)
    batch_rules: Dict[str, Any] = {"batch": data if data else None}

    def fsdp_axis() -> Optional[str]:
        for a in ("fsdp", "data"):
            if a in mesh_axes and mesh_axes[a] > 1:
                return a
        return None

    def need(*axes: str) -> None:
        for ax in axes:
            if ax not in mesh_axes:
                article = "an" if ax[0] in "aeiou" else "a"
                raise RuntimeLayerError(f"{strategy} strategy needs {article} '{ax}' mesh axis")

    tensor_rules = {"heads": "tensor", "mlp": "tensor", "vocab": "tensor",
                    "attn_heads": "tensor"}
    if strategy == "ddp":
        return StrategyTemplate("ddp", batch_rules, data, options=options)
    if strategy == "fsdp":
        return StrategyTemplate("fsdp", {**batch_rules, "embed": fsdp_axis()}, data,
                                options=options)
    if strategy == "tp":
        rules = {**batch_rules, **tensor_rules, "experts": "tensor"}
        need("tensor")
        return StrategyTemplate("tp", rules, data, options=options)
    if strategy == "tp_dp":
        need("tensor")
        rules = {**batch_rules, "embed": fsdp_axis(), **tensor_rules}
        return StrategyTemplate("tp_dp", rules, data, options=options)
    if strategy == "pp":
        need("pipeline")
        return StrategyTemplate(
            "pp", {**batch_rules, "layers": "pipeline"}, data, pipeline_axis="pipeline",
            num_microbatches=int(options.get("num_microbatches", mesh_axes["pipeline"])),
            options=options,
        )
    if strategy == "pp_tp":
        need("pipeline", "tensor")
        return StrategyTemplate(
            "pp_tp", {**batch_rules, "layers": "pipeline", **tensor_rules}, data,
            pipeline_axis="pipeline", pipeline_composed=True,
            num_microbatches=int(options.get("num_microbatches", mesh_axes["pipeline"])),
            options=options,
        )
    if strategy == "sp_ring":
        need("sequence")
        return StrategyTemplate("sp_ring", {**batch_rules, "seq": "sequence"}, data,
                                ring_axis="sequence", options=options)
    if strategy == "ulysses":
        need("sequence")
        rules = {**batch_rules, "seq": "sequence", "attn_heads": "sequence"}
        return StrategyTemplate("ulysses", rules, data, ulysses_axis="sequence",
                                options=options)
    if strategy == "ep":
        need("expert")
        rules = {**batch_rules, "experts": "expert", "embed": fsdp_axis()}
        return StrategyTemplate("ep", rules, data, options=options)
    if strategy == "custom":
        rules = dict(options.get("rules", {}))
        rules.setdefault("batch", data if data else None)
        return StrategyTemplate(
            "custom", rules, tuple(options.get("batch_axes", data)),
            ring_axis=options.get("ring_axis"), pipeline_axis=options.get("pipeline_axis"),
            num_microbatches=int(options.get("num_microbatches", 1)), options=options,
        )
    raise RuntimeLayerError(f"Unknown strategy {strategy!r}")
