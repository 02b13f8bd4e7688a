"""Run tracking of the port (counterpart of ``polyaxon_tpu.tracking``)."""
