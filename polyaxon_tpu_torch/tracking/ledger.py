"""Analytic train-step FLOPs.

The port's copy of ``transformer_flops_per_token`` from
``polyaxon_tpu/tracking/ledger.py`` (the utilization ledger itself is not
ported yet).
"""

from __future__ import annotations


def transformer_flops_per_token(
    n_params: int, n_layers: int, n_heads: int, head_dim: int, seq: int
) -> float:
    """Train-step FLOPs per token: 6·N (fwd+bwd matmuls) + attention
    scores 12·L·H·hd·T (fwd+bwd, causal halves then doubles back) — the
    same accounting ``bench.py`` uses for its headline MFU."""
    return 6.0 * n_params + 12.0 * n_layers * n_heads * head_dim * seq
