"""Logical-axis sharding: name tensor dimensions, map names to mesh axes.

Counterpart of ``polyaxon_tpu/parallel/axes.py`` (:24-121).  Every parameter
carries a tuple of *logical* axis names (``("embed", "mlp")``, the models'
``param_axes``), and a strategy template's rules map names to mesh axes
(``{"mlp": "tensor"}``).  There XLA places each array by the resulting
``PartitionSpec`` and inserts the collectives; here a spec is a plain tuple
with the same entries (a mesh axis, a tuple of them, or None per dimension),
each rank holds its shard of every tensor (:func:`shard_tensor`), and the
model code gathers and reduces itself (``parallel/collectives.py``).

Rank r holds device r's shard of the reference's mesh: ranks lie row-major
over the mesh's axes (``runtime/mesh.py``), and a dimension split over the
axes ``(a, b)`` gives rank r the block ``index(a) · size(b) + index(b)``
(``Mesh.shard``), as ``PartitionSpec((a, b))`` does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from polyaxon_tpu_torch.parallel.collectives import gather_along, gather_from_group
from polyaxon_tpu_torch.parallel.templates import AxisRules, RuntimeLayerError

#: One dimension's entry of a spec: a mesh axis, a tuple of them, or None.
SpecEntry = Union[str, Tuple[str, ...], None]
Spec = Tuple[SpecEntry, ...]


def logical_to_spec(axes: Sequence[Optional[str]], rules: AxisRules, mesh_axes=None) -> Spec:
    """One tensor's logical axes → its spec (``logical_to_spec``, reference
    :27-60): with ``mesh_axes`` (axis → size) a rule naming an axis absent
    from the mesh degrades to replication; a mesh axis splits at most one
    dimension of a tensor (the first that asks for it); trailing Nones drop."""
    entries = []
    used: set = set()
    for name in axes:
        target = rules.get(name) if name is not None else None
        if target is None:
            entries.append(None)
            continue
        parts = (target,) if isinstance(target, str) else tuple(target)
        if mesh_axes is not None:
            parts = tuple(p for p in parts if p in mesh_axes)
        parts = tuple(p for p in parts if p not in used)
        used.update(parts)
        if not parts:
            entries.append(None)
        elif len(parts) == 1:
            entries.append(parts[0])
        else:
            entries.append(parts)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _is_axes_leaf(x: Any) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: Callable = lambda x: False) -> Any:
    """``fn`` over the leaves of nested dicts (and the matching leaves of
    ``rest``, trees of the same keys)."""
    if isinstance(tree, dict) and not is_leaf(tree):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf) for k in tree}
    return fn(tree, *rest)


def tree_specs(axes_tree: Any, rules: AxisRules, mesh_axes=None) -> Any:
    """:func:`logical_to_spec` over a tree of logical-axes tuples (reference
    :63-74)."""
    return tree_map(lambda axes: logical_to_spec(axes, rules, mesh_axes), axes_tree,
                    is_leaf=_is_axes_leaf)


def validate_rules(rules: AxisRules, mesh_axes: Dict[str, int]) -> None:
    """Reject rules that name axes the mesh does not have (reference
    :110-121, strict mode)."""
    for logical, target in rules.items():
        if target is None:
            continue
        parts = (target,) if isinstance(target, str) else target
        missing = [p for p in parts if p not in mesh_axes]
        if missing:
            raise RuntimeLayerError(
                f"Rule {logical!r} -> {target!r} references mesh axes {missing} "
                f"not present in {list(mesh_axes)}"
            )


def entry_axes(entry: SpecEntry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis that splits some dimension of a tensor with ``spec``."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def shard_tensor(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of ``full`` under ``spec``: along each dimension its
    block (``Mesh.shard`` over the entry's axes), as a tensor of its own (a
    view would keep the whole tensor's storage alive)."""
    out = full
    for dim, entry in enumerate(spec):
        index, count = mesh.shard(entry_axes(entry))
        if count > 1:
            size = out.shape[dim] // count
            out = out.narrow(dim, index * size, size)
    return out if out is full else out.clone()


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree, in key order."""
    if isinstance(specs, dict):
        return [leaf for key in specs for leaf in spec_leaves(specs[key])]
    return [specs]


def gather_shards(t: torch.Tensor, spec: Spec, mesh, keep: Sequence[str] = (),
                  replicated: Sequence[str] = ()) -> torch.Tensor:
    """``t``, this rank's shard under ``spec``, gathered along every
    dimension split over axes not in ``keep``.  Over an axis of
    ``replicated``, whose ranks hold the same rows and so the same grads,
    the gather is :func:`~polyaxon_tpu_torch.parallel.collectives.gather_from_group`
    (its backward keeps this rank's block of the grad); over any other,
    :func:`~polyaxon_tpu_torch.parallel.collectives.gather_along` (its
    backward reduce-scatters: the sum of the ranks' grads, cut to the shard).
    Every rank of those axes must call it."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if any(a in keep for a in axes):
            if len(axes) > 1:
                raise NotImplementedError(
                    f"a dimension split over {axes} with a local axis among them is not "
                    "ported (ROADMAP item 7: multi-process and parallelism)")
            continue
        for a in reversed(axes):  # innermost first: the blocks of each outer index
            gather = gather_from_group if a in replicated else gather_along
            t = gather(t, dim, mesh.group(a))
    return t


def tree_shard(tree: Any, specs: Any, mesh) -> Any:
    """:func:`shard_tensor` over a param tree and its spec tree."""
    return tree_map(lambda t, spec: shard_tensor(t, spec, mesh), tree, specs)


def full_shape(shape: Sequence[int], spec: Spec, mesh_axes: Dict[str, int]) -> Tuple[int, ...]:
    """The global shape of a shard of ``shape`` under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[dim] *= mesh_axes.get(a, 1)
    return tuple(out)


class Placement:
    """Where a model's parameters lie under a template on a mesh, and how
    each is gathered at its use.

    ``specs`` is the spec tree of ``axes_tree`` under the template's rules
    (None without a template and mesh: every parameter whole).
    The *local* axes are those whose split dimensions stay split at use,
    each named by the template, none by the strategy's name:

    - ``tp_axis``, the mesh axis, above 1, the rules split the heads over
      (``tensor`` under ``tp``, ``tp_dp`` and ``pp_tp``), where the
      tensor-parallel compute runs on the rank's block;
    - the template's ``pipeline_axis`` when the caller runs a schedule over
      it (``pipeline_local``: the transformer's stages keep their layers);
      the image models run none and gather the ``layers`` split at use, as
      the reference's ViT takes ``layers: pipeline`` as a placement
      (``polyaxon_tpu/models/vit.py:181``, a ``lax.scan`` over the stacked
      params);
    - ``expert_axis``, the mesh axis, above 1, of the ``experts`` rule
      (``expert`` under ``ep``, ``tensor`` under ``tp``): a rank computes
      its own experts.

    Every other split dimension is gathered (:func:`gather_shards`): over
    the axes whose grads the train step sums (the template's batch axes and
    its ring or Ulysses axis) by ``gather_along``, whose backward
    reduce-scatters the grad into the rank's shard; over the others
    (``replicated``: ``pipeline`` for the image models, an axis that only a
    ``custom`` rule names), whose ranks hold the same rows, by
    ``gather_from_group``, whose backward keeps the rank's block, since a
    reduce-scatter there would sum n equal grads.
    """

    def __init__(self, axes_tree: Any, template=None, mesh=None,
                 pipeline_local: bool = True) -> None:
        self.mesh = mesh
        self.specs = None
        self.tp_axis: Optional[str] = None
        self.expert_axis: Optional[str] = None
        self.local_axes: Tuple[str, ...] = ()
        self.replicated_axes: Tuple[str, ...] = ()
        if template is not None and mesh is not None:
            self.specs = tree_specs(axes_tree, template.rules, mesh.shape)

            def wide(target):
                return target if isinstance(target, str) and mesh.shape.get(target, 1) > 1 else None

            self.tp_axis = wide(template.rules.get("heads"))
            self.expert_axis = wide(template.rules.get("experts"))
            pipeline = wide(template.pipeline_axis) if pipeline_local else None
            local = (self.tp_axis, pipeline, self.expert_axis)
            self.local_axes = tuple(dict.fromkeys(a for a in local if a is not None))
            summed = set(template.batch_axes) | {template.ring_axis, template.ulysses_axis}
            self.replicated_axes = tuple(a for a in mesh.shape if a not in summed)

    @property
    def tp_group(self):
        """The process group of :attr:`tp_axis` (None without one)."""
        return None if self.tp_axis is None else self.mesh.group(self.tp_axis)

    def spec(self, *path: str) -> Spec:
        """The spec of the parameter at ``path`` (``()``: whole)."""
        node = self.specs
        if node is None:
            return ()
        for key in path:
            node = node[key]
        return node

    def at(self, params: Any, *path: str) -> torch.Tensor:
        """The parameter at ``path`` of ``params`` as its use takes it
        (:meth:`use`)."""
        for key in path:
            params = params[key]
        return self.use(params, self.spec(*path))

    def use(self, w: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's shard ``w`` gathered along every dimension that
        ``spec`` splits over an axis not in :attr:`local_axes`."""
        return gather_shards(w, spec, self.mesh, self.local_axes, self.replicated_axes)
