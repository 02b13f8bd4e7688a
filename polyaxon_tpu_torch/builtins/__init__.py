"""Built-in entrypoints of the port (counterpart of ``polyaxon_tpu.builtins``)."""
