"""Health checks, the port's copy of ``polyaxon_tpu.checks``."""

from polyaxon_tpu_torch.checks.health import run_health_checks, task_counter_snapshot

__all__ = ["run_health_checks", "task_counter_snapshot"]
