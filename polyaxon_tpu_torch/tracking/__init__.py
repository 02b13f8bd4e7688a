"""Run tracking of the port (counterpart of ``polyaxon_tpu.tracking``)."""

from polyaxon_tpu_torch.tracking.reporter import Reporter

__all__ = ["Reporter"]
