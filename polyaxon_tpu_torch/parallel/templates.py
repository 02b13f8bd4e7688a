"""Parallelism strategies as templates: the port's copy of the JAX package's.

Counterpart of ``polyaxon_tpu/parallel/templates.py``: every strategy the
spec DSL names (``environment.topology.strategy``) resolves against a mesh's
axis sizes to a :class:`StrategyTemplate`, the same fields and the same
errors as there, as data.  The rules map logical axes (``batch``, ``seq``,
``embed``, ...) to mesh axes; in the port they are read, not compiled
(``parallel/axes.py`` turns them into each parameter's shard).
Every strategy is in :data:`PORTED_STRATEGIES`: the transformer
(:func:`polyaxon_tpu_torch.models.transformer.forward`,
:func:`polyaxon_tpu_torch.runtime.train.build_train_step`) and the image
models (``models/vit.py``, ``models/cnn.py``) run each with its axes
across ranks (:func:`check_mesh`), and ``checkpoint-now`` serves every
template (``runtime/checkpoint.py:GangCheckpointNowService``).  What still
raises, naming ROADMAP item 7: a ``custom`` rule the port does not split
(:func:`check_rules`), and MoE under a ``custom`` pipeline with a tensor or
expert axis (``transformer.forward``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple, Union

#: logical axis name -> mesh axis (str), tuple of mesh axes, or None (replicate)
AxisRules = Mapping[str, Union[str, Tuple[str, ...], None]]

#: Mesh axes over which the *batch* may be sharded (data-like axes).
DATA_AXES = ("replica", "data", "fsdp")

#: The strategies the port's forward and train step run: all of them.
PORTED_STRATEGIES = ("ddp", "fsdp", "tp", "tp_dp", "pp", "pp_tp", "sp_ring", "ulysses", "ep",
                     "custom")
#: The logical axes of the transformer's parameters and activations that a
#: rule may map, and which :func:`check_rules` reads for each.
_TENSOR_RULES = ("heads", "mlp", "vocab")
_ITEM_7 = "(ROADMAP item 7: multi-process and parallelism)"


class RuntimeLayerError(Exception):
    """Mesh, strategy or runtime setup failed (the JAX package's error of the
    same name, kept apart so the port imports nothing of that package)."""


def _axes(target) -> Tuple[str, ...]:
    if target is None:
        return ()
    return (target,) if isinstance(target, str) else tuple(target)


def check_rules(template: "StrategyTemplate") -> None:
    """Raise on a rule the port does not split (only a ``custom`` template
    can hold one).  The port realizes a rule through a mechanism of its own,
    so it takes:

    - ``batch``: axes among the template's batch axes;
    - ``seq``: the ring axis (``ulysses``: its sequence axis);
    - ``heads``, ``mlp``, ``vocab``: none, or all three one axis (Megatron's
      split of the heads, MLP columns and vocabulary); ``attn_heads`` and
      ``act_mlp``: none or that axis (the Ulysses axis under ``ulysses``);
    - ``embed``: axes other than the tensor axis (gathered at each use);
    - ``layers``: the pipeline axis, which it must name when there is one;
    - ``experts``: one axis that splits no tokens and is not the pipeline's.

    Anything else (``head_dim``, a tuple for the tensor axis, an unknown
    name) raises ``NotImplementedError`` naming the rule."""
    rules = template.rules

    def refuse(name, why):
        raise NotImplementedError(
            f"strategy {template.name!r}: the rule {name!r} -> {rules.get(name)!r} is not "
            f"ported ({why}) {_ITEM_7}")

    tensor = {rules.get(n) for n in _TENSOR_RULES}
    if len(tensor) > 1:
        refuse("heads", "heads, mlp and vocab must map to one axis, not "
                        f"{sorted(map(str, tensor))}")
    tensor_axis = tensor.pop()
    if tensor_axis is not None and not isinstance(tensor_axis, str):
        refuse("heads", "the tensor-parallel split takes one mesh axis")
    tokens = set(template.batch_axes) | set(_axes(template.ring_axis)) | set(
        _axes(template.ulysses_axis))
    for name, target in rules.items():
        axes = _axes(target)
        if not axes or name in _TENSOR_RULES:
            continue
        if name == "batch":
            if not set(axes) <= set(template.batch_axes):
                refuse(name, f"the batch splits over the batch axes {template.batch_axes}")
        elif name == "seq":
            if axes != _axes(template.ring_axis or template.ulysses_axis):
                refuse(name, "the sequence splits over a ring or Ulysses axis only")
        elif name in ("attn_heads", "act_mlp"):
            if axes != _axes(tensor_axis) and axes != _axes(template.ulysses_axis):
                refuse(name, "it may name only the tensor or Ulysses axis")
        elif name == "embed":
            if tensor_axis in axes:
                refuse(name, "the tensor axis splits the heads, not the embedding")
        elif name == "layers":
            if axes != _axes(template.pipeline_axis):
                refuse(name, "the layers split over the pipeline axis only")
        elif name == "experts":
            if len(axes) > 1 or axes[0] in tokens or axes[0] == template.pipeline_axis:
                refuse(name, "the experts split over one axis that splits no tokens")
        else:
            refuse(name, "the port splits no such axis")
    if template.pipeline_axis is not None:
        if _axes(rules.get("layers")) != (template.pipeline_axis,):
            refuse("layers", f"a pipeline over {template.pipeline_axis!r} needs the rule "
                             f"layers -> {template.pipeline_axis!r}")
        if template.ring_axis is not None or template.ulysses_axis is not None:
            refuse("seq", "a pipeline runs no sequence axis")


def check_ported(template: Optional["StrategyTemplate"]) -> None:
    """Raise unless ``template`` is None or one of :data:`PORTED_STRATEGIES`
    whose rules the port splits (:func:`check_rules`)."""
    if template is None:
        return
    if template.name not in PORTED_STRATEGIES:
        raise NotImplementedError(
            f"strategy {template.name!r} is not ported yet; {', '.join(PORTED_STRATEGIES)} "
            f"are {_ITEM_7}"
        )
    check_rules(template)


def check_mesh(template: Optional["StrategyTemplate"], mesh) -> Optional[str]:
    """The ring axis a ported template runs over (None: no ring), or raise
    on what the port does not run yet: a rule it does not split
    (:func:`check_ported`), a mesh above one rank without a template, or a
    mesh axis above 1 that the template does not spread over: its batch
    axes, its ring or Ulysses sequence axis, its pipeline axis and every
    axis its rules name (the fsdp axis, ``tensor``, ``expert``)."""
    if template is None:
        if mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"a mesh {mesh.shape} without a strategy template is not ported "
                "(ROADMAP item 7: multi-process and parallelism)"
            )
        return None
    check_ported(template)
    if mesh is None:
        raise ValueError(f"strategy template {template.name!r} needs a mesh")
    spread = set(template.batch_axes) | {template.ring_axis, template.ulysses_axis,
                                         template.pipeline_axis}
    for target in template.rules.values():
        spread.update((target,) if isinstance(target, str) else target or ())
    wide = {a: n for a, n in mesh.shape.items() if n > 1 and a not in spread}
    if wide:
        raise NotImplementedError(
            f"strategy {template.name!r} on mesh axes {wide} is not ported yet: only its "
            "batch axes, its sequence or pipeline axis and the axes its rules shard "
            "parameters over may span ranks (ROADMAP item 7: multi-process and parallelism)"
        )
    return template.ring_axis


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
    #: Ulysses sequence axis (all-to-all attention)
    ulysses_axis: Optional[str] = None
    #: layers are pipeline stages over this mesh axis (pp, pp_tp)
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
