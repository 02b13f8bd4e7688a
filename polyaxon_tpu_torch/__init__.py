"""polyaxon_tpu_torch — the PyTorch / CUDA port of polyaxon_tpu for NVIDIA Hopper.

A package of its own beside ``polyaxon_tpu`` (the JAX reference, which it
never imports).  Plain tensor code is PyTorch; every TPU kernel of a ported
path is a CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built at first use.
Entry points run on the card (``device="cuda"``) and raise without one,
unless the caller asks for ``device="cpu"``, where the kernels' plain
PyTorch versions run.
"""

from polyaxon_tpu_torch._device import kernels_available, resolve_device

__version__ = "0.1.0"
__all__ = ["kernels_available", "resolve_device"]
