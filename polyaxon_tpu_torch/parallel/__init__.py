"""Attention kernels of the port (counterpart of ``polyaxon_tpu.parallel``)."""
