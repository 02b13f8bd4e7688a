"""AdamW, equal to ``optax.adamw`` as the JAX package calls it.

``optax.adamw(lr, mu_dtype=...)`` is ``scale_by_adam`` → ``add_decayed_weights``
→ ``scale_by_learning_rate``.  This module does the same arithmetic in the
same order and rounds where optax rounds, so a step here and a step there
agree to float32 rounding:

- mu' = (1 − b1)·g + b1·mu in float32, where b1 is first rounded to mu's
  dtype: JAX gives a Python scalar the dtype of the array it multiplies, so
  with a bf16 mu the decay is bf16(0.9) = 0.8984375 (inside ``jit``, as the
  JAX train step runs it, the product itself stays float32);
  nu' = (1 − b2)·g² + b2·nu in float32;
- the update uses the float32 mu'; mu is stored back in ``mu_dtype``;
- bias correction 1 − b**count in float32, then
  u = mû / (sqrt(nû + eps_root) + eps) + weight_decay·p and p ← p + (−lr)·u.

``torch.optim.AdamW`` does not serve: its default decay is 1e-2 and it
cannot keep mu in bf16.  Parameters, mu and nu are updated in place under
``no_grad`` (the counterpart of the JAX step's ``donate_argnums``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


@dataclass
class AdamWState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


# optax.adamw's defaults, the values the JAX package runs with.
B1, B2, EPS, EPS_ROOT, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.0, 1e-4


@dataclass(frozen=True)
class AdamW:
    """``optax.adamw(learning_rate, mu_dtype=mu_dtype)``."""

    learning_rate: float
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: Any) -> AdamWState:
        leaves = tree_leaves(params)
        return AdamWState(
            count=0,
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for p in leaves],
            nu=[torch.zeros_like(p) for p in leaves],
        )

    @torch.no_grad()
    def update_(self, params: Any, grads: List[torch.Tensor], state: AdamWState) -> AdamWState:
        """One step: ``params`` (in ``tree_leaves`` order, matching
        ``grads``), ``state.mu`` and ``state.nu`` change in place."""
        state.count += 1
        # optax takes decay**count in float32 (count is an int32 array).
        one = np.float32(1.0)
        bc1 = float(one - np.float32(B1) ** np.float32(state.count))
        bc2 = float(one - np.float32(B2) ** np.float32(state.count))
        for p, g, mu, nu in zip(tree_leaves(params), grads, state.mu, state.nu):
            b1 = torch.tensor(B1, dtype=mu.dtype).item()
            mu32 = torch.mul(g, 1 - B1).add_(torch.mul(mu.float(), b1))
            nu.copy_(torch.mul(g.square(), 1 - B2).add_(torch.mul(nu, B2)))
            u = (mu32 / bc1).div_((nu / bc2).add_(EPS_ROOT).sqrt_().add_(EPS))
            u.add_(torch.mul(p, WEIGHT_DECAY))
            p.add_(u.mul_(-self.learning_rate))
            mu.copy_(mu32)
        return state
