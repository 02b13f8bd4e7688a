"""Carry a JAX parameter tree into the port, leaf by leaf.

The JAX package's ``init_params`` tree, converted to numpy arrays by the
caller, becomes the same nested dict of torch tensors with the same
layouts.  JAX parameters are float32, which numpy carries exactly.  numpy
has no bfloat16 of its own: a bf16 leaf (numpy dtype name ``bfloat16``)
crosses as its 16-bit pattern, viewed as int16 and back.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from polyaxon_tpu_torch._device import DeviceLike, resolve_device


def _leaf(arr: Any, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.array(arr)  # a writable, contiguous copy (JAX's arrays are read-only)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device: DeviceLike = "cuda", dtype: Optional[torch.dtype] = None):
    """Nested dicts / tuples / lists of numpy arrays → the same structure of
    tensors on ``device``.  ``dtype`` recasts floating leaves (None keeps
    them); integer leaves (int8 quantized weights) keep their type."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_jax(v, dev, dtype) for v in tree)
    return _leaf(tree, dev, dtype)
