"""Worker-side telemetry of the port (counterpart of ``polyaxon_tpu.monitor``'s
resource sampler)."""
