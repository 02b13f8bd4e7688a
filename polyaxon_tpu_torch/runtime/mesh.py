"""The port's device mesh: named axes, this process's rank on each, and a
``torch.distributed`` group for each axis that spans more than one rank.

Counterpart of ``polyaxon_tpu/runtime/mesh.py:build_mesh``.  A JAX mesh lays
every device of the job out on its axes; under PyTorch each process holds
its own shard, so the port's mesh is this process's view of the layout:
``shape`` (axis name → size, as ``jax.sharding.Mesh.shape``), its rank on
each axis, and the group over which it talks along that axis.  An axis of
size 1 needs no group, so a one-card job needs no ``init_process_group``.
Building the groups (NCCL gangs, a port worker and spawner) is ROADMAP
item 7; the caller supplies them here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch.distributed as dist

from polyaxon_tpu_torch.parallel.ring import GroupRing
from polyaxon_tpu_torch.parallel.templates import RuntimeLayerError


class Mesh:
    """Named axes with their sizes, this process's rank on each, and the
    process group of each axis of size > 1."""

    def __init__(self, axes: Dict[str, int], groups: Dict[str, dist.ProcessGroup]) -> None:
        self.shape: Dict[str, int] = dict(axes)
        self._groups = dict(groups)
        self._rings: Dict[str, GroupRing] = {}

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The process group along ``axis`` (None for an axis of size 1)."""
        return self._groups.get(axis)

    def rank(self, axis: str) -> int:
        """This process's rank along ``axis``."""
        group = self._groups.get(axis)
        return 0 if group is None else group.rank()

    def ring(self, axis: str) -> GroupRing:
        """The ring along ``axis`` (one per axis, built on first use)."""
        if axis not in self.shape:
            raise RuntimeLayerError(f"mesh {self.shape} has no axis {axis!r}")
        if axis not in self._rings:
            self._rings[axis] = GroupRing(self._groups.get(axis))
        return self._rings[axis]

    def __repr__(self) -> str:
        ranks = {a: self.rank(a) for a in self.shape}
        return f"Mesh(shape={self.shape}, ranks={ranks})"


def build_mesh(
    axes: Dict[str, int], groups: Optional[Dict[str, dist.ProcessGroup]] = None
) -> Mesh:
    """A :class:`Mesh` over ``axes`` (name → size, outermost first).

    ``groups`` gives the process group of every axis whose size is above 1;
    its size must equal the axis size.  Axes of size 1 take no group.
    """
    groups = dict(groups or {})
    for name, size in axes.items():
        if int(size) < 1:
            raise RuntimeLayerError(f"mesh axis {name!r} has size {size}")
    unknown = set(groups) - set(axes)
    if unknown:
        raise RuntimeLayerError(f"groups for axes {sorted(unknown)} not in mesh axes {axes}")
    for name, size in axes.items():
        group = groups.get(name)
        if size > 1 and group is None:
            raise RuntimeLayerError(
                f"mesh axis {name!r} of size {size} needs a torch.distributed group "
                "(multi-process gangs: ROADMAP item 7)"
            )
        if size == 1 and group is not None:
            raise RuntimeLayerError(f"mesh axis {name!r} of size 1 takes no group")
        if group is not None and group.size() != size:
            raise RuntimeLayerError(
                f"the group of mesh axis {name!r} has {group.size()} ranks, the axis {size}"
            )
    return Mesh({name: int(size) for name, size in axes.items()}, groups)
