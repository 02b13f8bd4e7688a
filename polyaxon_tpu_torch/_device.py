"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device="cuda"`` is the default, and without CUDA it raises instead of
quietly running the plain versions on the host.  ``device="cpu"`` is an
explicit request (the parity tests make it).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and there
    is none (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def require_on(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor lies on ``device`` (no hidden copies:
    moving the weights per call would cost more than the call)."""
    for name, t in tensors.items():
        if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index
        ):
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def find_nvcc() -> Optional[str]:
    """Path of the CUDA compiler, or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def kernels_available() -> Dict[str, Any]:
    """What the kernels need, as found: a report, never a fallback switch."""
    cuda = torch.cuda.is_available()
    return {
        "cuda": cuda,
        "device": torch.cuda.get_device_name(0) if cuda else None,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": find_nvcc(),
    }
