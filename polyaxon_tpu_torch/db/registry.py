"""Remediation-row statuses, as ``polyaxon_tpu/db/registry.py`` names them.

The port's own copy of ``RemediationStatus``: the fleet autoscaler writes
its ``scale_up`` / ``scale_down`` rows with these values through whatever
registry its fleet's orchestrator carries (duck-typed), so they must be
the reference's strings.
"""

from __future__ import annotations


class RemediationStatus:
    """Lifecycle of a remediation action (the detection→action loop).

    PENDING (decided, not yet acting) → IN_PROGRESS (command issued /
    process signalled) → SUCCEEDED / FAILED.  SKIPPED records a decision
    *not* to act (budget exhausted) so the run's timeline explains
    inaction; EXPIRED is the control plane closing rows left open when the
    run reached a terminal state.
    """

    PENDING = "pending"
    IN_PROGRESS = "in_progress"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    SKIPPED = "skipped"
    EXPIRED = "expired"

    OPEN = (PENDING, IN_PROGRESS)
    TERMINAL = (SUCCEEDED, FAILED, SKIPPED, EXPIRED)
