"""Flash attention forward: the Hopper kernel, its wrapper and its plain version.

Counterpart of ``polyaxon_tpu/parallel/flash.py`` (``flash_block_fwd`` and
the single-device ``flash_attention``).  The kernel is hand-written CUDA C++
for ``sm_90a`` (``csrc/flash_fwd.cu``, replacing the TPU's ``_fwd_kernel``),
built at first use and bound through ``ctypes``.

The wrapper dispatches on where its tensors lie, and on nothing else: a CPU
tensor goes to :func:`flash_block_fwd_reference`, a CUDA tensor to the
kernel, which either launches or raises.  ``lse`` is ``[BH, T]``: the TPU's
lane-replicated ``[BH, T, 128]`` layout was a Mosaic tiling rule.

The backward kernels (``_dq_kernel``, ``_dkv_kernel``) belong to the
training slice; until then the kernel path refuses to run under autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from polyaxon_tpu_torch import _build
from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device

_NEG_BIG = -1e30  # mask value; finite so masked rows stay NaN-free
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def flash_block_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same ``(o, lse)``, float32.

    One-pass softmax over the whole key axis, in float32 from the inputs as
    given; ``p`` is rounded to v's dtype before P·V as the kernel rounds it.
    """
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    if Tk == 0:  # an empty key block: the log-sum-exp merge's identity
        return (
            torch.zeros((BH, Tq, d), dtype=torch.float32, device=q.device),
            torch.full((BH, Tq), float("-inf"), dtype=torch.float32, device=q.device),
        )
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        keep = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_BIG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~keep, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    o = pv / torch.where(l > 0, l, torch.ones_like(l))
    lse = torch.where(
        l > 0, m + torch.log(torch.clamp(l, min=1e-38)), torch.full_like(l, float("-inf"))
    )
    return o, lse[..., 0]


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [BH, T, d]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[2] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_KERNEL_HEAD_DIMS}, got {q.shape[2]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


@functools.cache  # build and bind once; a failed build is not cached and raises again
def _kernel_fn():
    fn = _build.load("flash_fwd").flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_block_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention block: ``(o, lse)``, o float32-normalized, lse ``[BH, Tq]``.

    q: [BH, Tq, d]; k, v: [BH, Tk, d].  ``causal`` masks assuming q and k
    share a global offset.  On CUDA tensors this launches the kernel (and
    adds one to ``flash_block_fwd.launches``); on CPU tensors it is the
    plain version.
    """
    if q.device.type == "cpu":
        return flash_block_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    check_kernel_inputs(q, k, v)
    BH, Tq, d = q.shape
    Tk = k.shape[1]
    o = torch.empty((BH, Tq, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
    if BH == 0 or Tq == 0:
        return o, lse
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            BH, Tq, Tk, d, _KERNEL_DTYPES[q.dtype], int(bool(causal)), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_block_fwd.launches += 1
    return o, lse


flash_block_fwd.launches = 0


def _bhd(x: torch.Tensor) -> torch.Tensor:
    B, T, H, d = x.shape
    return x.transpose(1, 2).reshape(B * H, T, d)


def _unbhd(x: torch.Tensor, B: int, H: int) -> torch.Tensor:
    BH, T, d = x.shape
    return x.reshape(B, H, T, d).transpose(1, 2)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    *,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Causal flash attention. q/k/v: [B, T, H, d] → [B, T, H, d] in q's dtype."""
    dev = resolve_device(device)
    require_on(dev, q=q, k=k, v=v)
    if dev.type == "cuda" and torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "flash attention backward (_dq_kernel/_dkv_kernel) is not ported yet "
            "(ROADMAP: training slice)"
        )
    B, T, H, d = q.shape
    o, _ = flash_block_fwd(_bhd(q), _bhd(k), _bhd(v), causal=True, sm_scale=sm_scale)
    return _unbhd(o, B, H).to(q.dtype)
