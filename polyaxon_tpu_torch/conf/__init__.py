"""Configuration of the port (counterpart of ``polyaxon_tpu.conf``)."""
