"""Ulysses sequence parallelism: attention over the whole sequence on a
rank's share of the heads.

Counterpart of ``polyaxon_tpu/parallel/ulysses.py`` (:28-77).  Each rank
holds a contiguous sequence shard of q/k/v, ``[B, T/n, H, d]``; one
all-to-all a tensor swaps it for the whole sequence on ``H/n`` heads,
``[B, T, H/n, d]``; attention runs there (the flash kernels, or dense
attention), and the reverse all-to-all swaps the output back.  The
reference's swap is ``lax.all_to_all`` inside ``shard_map``; here it is
:func:`~polyaxon_tpu_torch.parallel.collectives.all_to_all_swap`, whose
backward is the reverse swap, and the flash call carries its own backward,
so grads compose as there.
"""

from __future__ import annotations

from typing import Optional

import torch

from polyaxon_tpu_torch.parallel import flash
from polyaxon_tpu_torch.parallel.collectives import all_gather_cat, all_to_all_swap


def ulysses_attention_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    seq_axis: str,
    impl: str = "auto",
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal attention of this rank's sequence shard: q/k/v ``[B, T/n, H,
    d]`` (K/V already broadcast to the query heads) → ``[B, T/n, H, d]``
    (reference ``ulysses_attention_sharded`` :46-77).

    ``impl``: ``"flash"`` the flash wrapper over the whole sequence (the
    kernels on the card, their plain version on a CPU tensor), ``"dense"``
    dense attention over the global ``positions`` (this shard's, ``[B,
    T/n]``; default: contiguous shards from 0), ``"auto"`` the kernels where
    q lies on the card and they take its rank's shape and dtype, dense
    elsewhere.  Raises ``ValueError`` when the heads do not divide over the
    axis (reference :60-65).
    """
    n = mesh.shape[seq_axis]
    B, Tl, H, d = q.shape
    if H % n:
        raise ValueError(f"Ulysses needs heads ({H}) divisible by the '{seq_axis}' axis ({n})")
    if impl == "auto":
        takes = q.device.type == "cuda" and flash.kernel_takes((B, Tl * n, H // n, d), q.dtype)
        impl = "flash" if takes else "dense"
    if impl not in ("flash", "dense"):
        raise ValueError(f"Unknown Ulysses attention impl {impl!r}")
    group = mesh.group(seq_axis)
    # Sequence-sharded → head-sharded: split the heads, gather the sequence.
    qh, kh, vh = (all_to_all_swap(t, 2, 1, group) for t in (q, k, v))
    if impl == "flash":
        o = flash.flash_attention(qh, kh, vh, d**-0.5, device=q.device)
    else:
        if positions is None:
            positions = (mesh.rank(seq_axis) * Tl + torch.arange(Tl, device=q.device)).expand(B, Tl)
        # Imported here: the model imports this module.
        from polyaxon_tpu_torch.models.transformer import _dense_attention

        pos = all_gather_cat(positions.to(q.device), 1, group)
        o = _dense_attention(qh, kh, vh, pos, pos)
    # Head-sharded → sequence-sharded (the reverse swap).
    return all_to_all_swap(o, 1, 2, group)
