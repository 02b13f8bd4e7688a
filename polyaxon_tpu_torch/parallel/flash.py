"""Flash attention: the Hopper kernels, their wrappers and their plain versions.

Counterpart of ``polyaxon_tpu/parallel/flash.py`` (``flash_block_fwd``,
``flash_block_bwd`` and the single-device ``flash_attention`` with its
custom VJP).  The kernels are hand-written CUDA C++ for ``sm_90a``, built at
first use and bound through ``ctypes``: ``csrc/flash_fwd.cu`` replaces the
TPU's ``_fwd_kernel``, ``csrc/flash_bwd.cu`` its ``_dq_kernel`` and
``_dkv_kernel``.  With bf16 inputs all three run on the tensor cores
(``mma.sync``); with float32 inputs they use float32 FMAs.  Like the Pallas
kernels (whose blocks take the whole head_dim), they take every head_dim
from 1 to 256: the C entry points take multiples of 8 (rows of 16-byte
chunks), and the wrappers pad any other head_dim with zero columns to the
next multiple of 8 and slice the outputs (zero columns add exact zeros to
every score and give zero output columns), counting such calls in each
wrapper's ``padded``.

Each wrapper dispatches on where its tensors lie, and on nothing else: a CPU
tensor goes to the plain version, a CUDA tensor to the kernel, which either
launches or raises.  ``lse`` is ``[BH, T]``: the TPU's lane-replicated
``[BH, T, 128]`` layout was a Mosaic tiling rule.

``flash_attention`` is differentiable: it is the custom operator
``polyaxon_tpu_torch::flash_attention`` (so a selective-checkpoint policy
can name it and keep its output) with a registered autograd formula that
mirrors the JAX ``_flash_fwd``/``_flash_bwd`` pair.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Any, Sequence, Tuple

import torch

from polyaxon_tpu_torch import _build
from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device

_NEG_BIG = -1e30  # mask value; finite so masked rows stay NaN-free
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# torch's CPU ``exp`` sets itself up on its first call in a process.  When
# two threads make that first call at once (thread ranks entering the plain
# versions below together), one of them can get values off by about 1e-4
# relative (``tools/exp_first_call_race.py`` counts the processes where it
# happens: 4 of 96 cold, 0 of 96 after one call first), and the Ulysses rank
# threads' outputs then missed the reference by 7.5e-5.  The importing
# thread makes the first call here, before any rank thread starts.
torch.exp(torch.zeros(1))
_MAX_HEAD_DIM = 256  # the widest tile the kernels are compiled for (csrc/head_dims.cuh)


def _visible(Tq: int, Tk: int, device: torch.device) -> torch.Tensor:
    """[Tq, Tk] causal mask, q and k sharing one global offset."""
    return torch.ones((Tq, Tk), dtype=torch.bool, device=device).tril()


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
        keep = _visible(Tq, Tk, q.device)
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


def _check_aligned(**tensors: torch.Tensor) -> None:
    """The bf16 kernels copy rows 16 bytes at a time (``cp.async``)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"kernel takes 16-byte aligned tensors; {name}.data_ptr() is "
                             f"{t.data_ptr()}")


def kernel_takes(q_shape: Sequence[int], dtype: torch.dtype) -> bool:
    """Whether the kernels take q of this shape (head_dim last) and dtype.

    ``attention_impl="auto"`` picks the kernels on a CUDA tensor only where
    this holds, from the shape and dtype alone, before any launch; the rest
    of :func:`check_kernel_inputs` (layout, alignment) is the wrappers' own
    business and holds for every tensor they make.
    """
    return dtype in _KERNEL_DTYPES and 1 <= q_shape[-1] <= _MAX_HEAD_DIM


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be [BH, T, d]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not 1 <= q.shape[2] <= _MAX_HEAD_DIM:
        raise ValueError(f"kernel takes head_dim 1 to {_MAX_HEAD_DIM}, got {q.shape[2]}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("kernel takes contiguous q, k, v")
    _check_aligned(q=q, k=k, v=v)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def _padded_dim(d: int) -> int:
    """The head_dim the kernels run ``d`` at: the next multiple of 8."""
    return -(-d // 8) * 8


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    """x with zero columns appended to ``width`` (a fresh contiguous tensor)."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


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
    adds one to ``flash_block_fwd.launches``, and to ``.padded`` where
    head_dim is not a multiple of 8); on CPU tensors it is the plain version.
    """
    if q.device.type == "cpu":
        return flash_block_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return _kernel_fwd(q, k, v, causal, sm_scale)


def _kernel_fwd(q, k, v, causal, sm_scale):
    """The CUDA branch of :func:`flash_block_fwd`: check, pad head_dim to a
    multiple of 8 where it is not one, launch, count, slice."""
    check_kernel_inputs(q, k, v)
    BH, Tq, d = q.shape
    w = _padded_dim(d)
    o = torch.empty((BH, Tq, w), dtype=torch.float32, device=q.device)
    lse = torch.empty((BH, Tq), dtype=torch.float32, device=q.device)
    if BH and Tq:
        if w != d:
            q, k, v = (_pad(x, w) for x in (q, k, v))
            flash_block_fwd.padded += 1
        _launch_fwd(q, k, v, o, lse, causal, sm_scale)
        flash_block_fwd.launches += 1
    return (o if w == d else o[..., :d].contiguous()), lse


def _launch_fwd(q, k, v, o, lse, causal, sm_scale) -> None:
    """Launch the forward kernel on checked inputs, writing ``o`` and ``lse``."""
    BH, Tq, d = q.shape
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            BH, Tq, k.shape[1], d, _KERNEL_DTYPES[q.dtype], int(bool(causal)), float(sm_scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")


flash_block_fwd.launches = 0
flash_block_fwd.padded = 0


def flash_block_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the two backward kernels: ``(dq, dk, dv)`` f32.

    p = exp(s·scale − lse), masked to 0; dp = do·vᵀ; ds = p ⊙ (dp − delta)
    ·scale.  It rounds where the TPU kernels round (``flash.py:210, 249,
    258``): ds to k's dtype before dq = ds·k, p to do's dtype before
    dv = pᵀ·do, ds to q's dtype before dk = dsᵀ·q.  A row whose lse is −inf
    (it saw no key) contributes nothing, instead of exp(+inf).
    """
    Tq, Tk = q.shape[1], k.shape[1]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * sm_scale
    live = ~torch.isneginf(lse)
    p = torch.exp(s - torch.where(live, lse, 0.0)[..., None])
    keep = live[..., None]
    if causal:
        keep = keep & _visible(Tq, Tk, q.device)
    p = torch.where(keep, p, 0.0)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), kf)
    dv = torch.einsum("bqk,bqd->bkd", p.to(do.dtype).float(), dof)
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), qf)
    return dq, dk, dv


def check_bwd_inputs(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
) -> None:
    """Raise on anything the backward kernels do not take: the forward's
    checks on q, k, v, then do like q, and lse, delta float32 ``[BH, Tq]``."""
    check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype}, "
                         f"q {tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:2])}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not (do.is_contiguous() and lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError("kernel takes contiguous do, lse, delta")
    _check_aligned(do=do)
    if not (q.device == do.device == lse.device == delta.device):
        raise ValueError("q, do, lse, delta must lie on one device")


@functools.cache
def _bwd_kernel_fns():
    lib = _build.load("flash_bwd")
    ints = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + ints  # 6 inputs, dq
    lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 8 + ints  # 6 inputs, dk, dv
    for fn in (lib.flash_bwd_dq, lib.flash_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib.flash_bwd_dq, lib.flash_bwd_dkv


def _launch_bwd(fn, name, q, k, v, do, lse, delta, outs, causal, sm_scale) -> None:
    BH, Tq, d = q.shape
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), *(o.data_ptr() for o in outs), BH, Tq, k.shape[1], d,
                 _KERNEL_DTYPES[q.dtype], int(bool(causal)), float(sm_scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _on_cuda(q: torch.Tensor) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    return True


def flash_block_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
) -> torch.Tensor:
    """dq of one attention block, float32 [BH, Tq, d]: the dq kernel on CUDA
    tensors (adding one to ``flash_block_dq.launches``, and to ``.padded``
    where head_dim is not a multiple of 8), the plain version on CPU
    tensors."""
    if not _on_cuda(q):
        return flash_block_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                         sm_scale=sm_scale)[0]
    return _kernel_dq(q, k, v, do, lse, delta, causal, sm_scale)


def _kernel_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """The CUDA branch of :func:`flash_block_dq`, as :func:`_kernel_fwd`."""
    check_bwd_inputs(q, k, v, do, lse, delta)
    d, w = q.shape[2], _padded_dim(q.shape[2])
    dq = torch.empty((*q.shape[:2], w), dtype=torch.float32, device=q.device)
    if q.shape[0] and q.shape[1]:  # the kernel runs whenever dq is not empty
        if w != d:
            q, k, v, do = (_pad(x, w) for x in (q, k, v, do))
            flash_block_dq.padded += 1
        _launch_bwd(_bwd_kernel_fns()[0], "flash_bwd dq", q, k, v, do, lse, delta, (dq,),
                    causal, sm_scale)
        flash_block_dq.launches += 1
    return dq if w == d else dq[..., :d].contiguous()


def flash_block_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of one attention block, float32 [BH, Tk, d]: the dk/dv kernel
    on CUDA tensors (adding one to ``flash_block_dkv.launches``, and to
    ``.padded`` where head_dim is not a multiple of 8), the plain version on
    CPU tensors."""
    if not _on_cuda(q):
        return flash_block_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                         sm_scale=sm_scale)[1:]
    return _kernel_dkv(q, k, v, do, lse, delta, causal, sm_scale)


def _kernel_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    """The CUDA branch of :func:`flash_block_dkv`, as :func:`_kernel_fwd`."""
    check_bwd_inputs(q, k, v, do, lse, delta)
    d, w = k.shape[2], _padded_dim(k.shape[2])
    dk = torch.empty((*k.shape[:2], w), dtype=torch.float32, device=q.device)
    dv = torch.empty((*k.shape[:2], w), dtype=torch.float32, device=q.device)
    if k.shape[0] and k.shape[1]:  # the kernel runs whenever dk, dv are not empty
        if w != d:
            q, k, v, do = (_pad(x, w) for x in (q, k, v, do))
            flash_block_dkv.padded += 1
        _launch_bwd(_bwd_kernel_fns()[1], "flash_bwd dk/dv", q, k, v, do, lse, delta,
                    (dk, dv), causal, sm_scale)
        flash_block_dkv.launches += 1
    if w != d:
        dk, dv = dk[..., :d].contiguous(), dv[..., :d].contiguous()
    return dk, dv


flash_block_dq.launches = 0
flash_block_dkv.launches = 0
flash_block_dq.padded = 0
flash_block_dkv.padded = 0


def launch_counts() -> dict:
    """This process's launches of each flash kernel so far, by kernel name."""
    return {"flash_fwd": flash_block_fwd.launches, "flash_bwd_dq": flash_block_dq.launches,
            "flash_bwd_dkv": flash_block_dkv.launches}


def padded_counts() -> dict:
    """Of :func:`launch_counts`, the launches whose head_dim was padded to a
    multiple of 8, by kernel name."""
    return {"flash_fwd": flash_block_fwd.padded, "flash_bwd_dq": flash_block_dq.padded,
            "flash_bwd_dkv": flash_block_dkv.padded}


def flash_block_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of one attention block: ``(dq, dk, dv)``, float32.

    q, do: [BH, Tq, d]; k, v: [BH, Tk, d]; lse, delta: [BH, Tq] float32
    (delta = rowsum(do ⊙ o)).  On CUDA tensors this launches the dq kernel
    (:func:`flash_block_dq`) and the dk/dv kernel (:func:`flash_block_dkv`);
    on CPU tensors it is the plain version, once.
    """
    if not _on_cuda(q):
        return flash_block_bwd_reference(q, k, v, do, lse, delta, causal=causal,
                                         sm_scale=sm_scale)
    kw = dict(causal=causal, sm_scale=sm_scale)
    return (flash_block_dq(q, k, v, do, lse, delta, **kw),
            *flash_block_dkv(q, k, v, do, lse, delta, **kw))


def _bhd(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, d] → [B*H, T, d], contiguous as the kernels take it (with
    B = 1 a reshape alone would return a strided view)."""
    B, T, H, d = x.shape
    return x.transpose(1, 2).contiguous().view(B * H, T, d)


def _unbhd(x: torch.Tensor, B: int, H: int) -> torch.Tensor:
    BH, T, d = x.shape
    return x.reshape(B, H, T, d).transpose(1, 2)


@torch.library.custom_op("polyaxon_tpu_torch::flash_attention", mutates_args=())
def _flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention of [B, T, H, d] q/k/v: ``(out, lse)``, out in q's
    dtype (as JAX's ``_flash_fwd`` casts it), lse float32 [B*H, T]."""
    B, T, H, d = q.shape
    o, lse = flash_block_fwd(_bhd(q), _bhd(k), _bhd(v), causal=True, sm_scale=sm_scale)
    return _unbhd(o, B, H).to(q.dtype), lse


def _flash_setup_context(ctx, inputs, output) -> None:
    q, k, v, sm_scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)  # JAX's residuals (q, k, v, out, lse)
    ctx.sm_scale = sm_scale
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, dout: torch.Tensor, _dlse: torch.Tensor):
    """JAX's ``_flash_bwd``: delta = rowsum(do ⊙ out) in float32 from do
    cast to q's dtype and the saved out, then the two backward kernels; the
    grads come back in the inputs' dtypes."""
    q, k, v, out, lse = ctx.saved_tensors
    B, T, H, d = q.shape
    dof = _bhd(dout.to(q.dtype))
    delta = (dof.float() * _bhd(out).float()).sum(dim=-1)
    dq, dk, dv = flash_block_bwd(_bhd(q), _bhd(k), _bhd(v), dof, lse, delta, causal=True,
                                 sm_scale=ctx.sm_scale)
    return (_unbhd(dq, B, H).to(q.dtype), _unbhd(dk, B, H).to(k.dtype),
            _unbhd(dv, B, H).to(v.dtype), None)


torch.library.register_autograd(
    "polyaxon_tpu_torch::flash_attention", _flash_backward, setup_context=_flash_setup_context
)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
    *,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Causal flash attention. q/k/v: [B, T, H, d] → [B, T, H, d] in q's dtype.

    Differentiable: the backward runs :func:`flash_block_bwd` (the two
    backward kernels on CUDA, their plain version on the CPU).
    """
    dev = resolve_device(device)
    require_on(dev, q=q, k=k, v=v)
    out, _ = _flash_attention_op(q, k, v, float(sm_scale))
    return out


# ---------------------------------------------------------------------------
# The ring over the kernels: causal attention with the sequence split over
# the ranks of a ring (JAX: ``ring_flash_attention`` with ``_ring_flash_fwd``
# and ``_ring_flash_bwd``).  The hop arithmetic is plain functions of
# ``(q, k, v, ..., comm)``; ``comm`` gives ``rank``, ``size`` and
# ``rotate(tensors, reverse=False)`` (send to rank + 1, receive from
# rank - 1; reversed, the other way): a process group's
# (:class:`~polyaxon_tpu_torch.parallel.ring.GroupRing`) or threads' of one
# process (:class:`~polyaxon_tpu_torch.parallel.ring.LocalRing`).
# ---------------------------------------------------------------------------

_DIAGONAL, _FULL, _SKIP = 0, 1, 2


def _merge(o, lse, o_b, lse_b):
    """Log-sum-exp combine of two normalized partial attentions.  An empty
    block (lse −inf, o 0) is its identity; a row empty in both stays so."""
    lse_new = torch.logaddexp(lse, lse_b)
    dead = torch.isneginf(lse_new)
    w_old = torch.where(dead, 0.0, torch.exp(lse - lse_new))
    w_new = torch.where(dead, 0.0, torch.exp(lse_b - lse_new))
    return o * w_old[..., None] + o_b * w_new[..., None], lse_new


def _hop_case(i: int, idx: int) -> int:
    """At hop ``i`` rank ``idx`` holds the K/V block of rank ``idx - i``:
    0 = its own block (causal diagonal), 1 = an earlier block (full),
    2 = a later block (future keys: skipped)."""
    return _DIAGONAL if i == 0 else (_FULL if i <= idx else _SKIP)


def _gqa_expand(x: torch.Tensor, B: int, group: int) -> torch.Tensor:
    """[B*Hkv, T, d] → [B*H, T, d], each KV head repeated ``group`` times
    (query head h reads KV head h // group, as ``repeat_interleave``)."""
    if group == 1:
        return x
    BHkv, T, d = x.shape
    return x.reshape(B, BHkv // B, T, d).repeat_interleave(group, dim=1).reshape(-1, T, d)


def _gqa_reduce(dx: torch.Tensor, B: int, group: int) -> torch.Tensor:
    """Transpose of :func:`_gqa_expand`: sum the query heads' grads per KV head."""
    if group == 1:
        return dx
    BH, T, d = dx.shape
    return dx.reshape(B, BH // B // group, group, T, d).sum(dim=2).reshape(-1, T, d)


def ring_flash_fwd(q, k, v, sm_scale: float, comm) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's causal attention over the ring: ``(o, lse)``, both float32.

    q: [B, Tl, H, d], this rank's contiguous sequence shard; k, v:
    [B, Tl, Hkv, d] with Hkv dividing H (GQA).  The K/V blocks rotate
    unexpanded and are repeated to the query heads only at each kernel call
    (``check_kernel_inputs`` wants q and k with one batch of heads).  Hop 0
    is the causal diagonal block, earlier blocks are full, later ones are
    skipped; the partial results merge by log-sum-exp.  o is [B, Tl, H, d]
    (the custom op casts it to q's dtype), lse [B*H, Tl].  Adds one to
    ``ring_flash_fwd.blocks`` per block it computes.
    """
    n, idx = comm.size, comm.rank
    B, Tl, H, d = q.shape
    group = H // k.shape[2]
    qf, kc, vc = _bhd(q), _bhd(k), _bhd(v)
    o = torch.zeros((B * H, Tl, d), dtype=torch.float32, device=q.device)
    lse = torch.full((B * H, Tl), float("-inf"), dtype=torch.float32, device=q.device)
    for i in range(n):
        case = _hop_case(i, idx)
        if case != _SKIP:
            o_b, lse_b = flash_block_fwd(qf, _gqa_expand(kc, B, group), _gqa_expand(vc, B, group),
                                         causal=case == _DIAGONAL, sm_scale=sm_scale)
            o, lse = _merge(o, lse, o_b, lse_b)
            ring_flash_fwd.blocks += 1
        if i < n - 1:  # a last rotation would only bring the blocks home
            kc, vc = comm.rotate((kc, vc))
    return _unbhd(o, B, H), lse


ring_flash_fwd.blocks = 0


def ring_flash_bwd(q, k, v, out, lse, do, sm_scale: float, comm):
    """Grads of :func:`ring_flash_fwd`: ``(dq, dk, dv)`` float32 (the custom
    op casts them to the inputs' dtypes), dk and dv [B, Tl, Hkv, d].  out is
    the forward's output in q's dtype.

    Every hop uses the final merged ``lse`` and delta = rowsum(do ⊙ out) in
    float32, as JAX's ``_ring_flash_bwd`` does.  The dk/dv accumulators
    (Hkv-sized, float32) travel with their K/V block; the n-th rotation,
    which carries only them, is what brings each block's grads home.
    """
    n, idx = comm.size, comm.rank
    B, Tl, H, d = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qf, kc, vc = _bhd(q), _bhd(k), _bhd(v)
    dof = _bhd(do.to(q.dtype))
    delta = (dof.float() * _bhd(out).float()).sum(dim=-1)
    dq = torch.zeros((B * H, Tl, d), dtype=torch.float32, device=q.device)
    dkc = torch.zeros((B * Hkv, Tl, d), dtype=torch.float32, device=q.device)
    dvc = torch.zeros_like(dkc)
    for i in range(n):
        case = _hop_case(i, idx)
        if case != _SKIP:
            dq_i, dk_i, dv_i = flash_block_bwd(
                qf, _gqa_expand(kc, B, group), _gqa_expand(vc, B, group), dof, lse, delta,
                causal=case == _DIAGONAL, sm_scale=sm_scale)
            dq = dq + dq_i
            dkc = dkc + _gqa_reduce(dk_i, B, group)
            dvc = dvc + _gqa_reduce(dv_i, B, group)
        if i < n - 1:
            kc, vc, dkc, dvc = comm.rotate((kc, vc, dkc, dvc))
        else:
            dkc, dvc = comm.rotate((dkc, dvc))
    return _unbhd(dq, B, H), _unbhd(dkc, B, Hkv), _unbhd(dvc, B, Hkv)


#: The rings the custom op below can name, by key.  A custom op takes no
#: process group, so it takes the key :func:`ring_key` gives its ring; the
#: entry lives as long as the ring object (its mesh holds it).
_RINGS: "weakref.WeakValueDictionary[str, Any]" = weakref.WeakValueDictionary()


def ring_key(comm) -> str:
    """The key under which :func:`ring_flash_attention` finds ``comm``."""
    key = f"ring-{id(comm)}"
    _RINGS[key] = comm
    return key


def _ring(key: str):
    comm = _RINGS.get(key)
    if comm is None:
        raise RuntimeError(f"ring {key!r} is gone (its mesh was released)")
    return comm


@torch.library.custom_op("polyaxon_tpu_torch::ring_flash_attention", mutates_args=())
def _ring_flash_attention_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, ring: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ring_flash_fwd` over the ring named ``ring``: ``(out, lse)``,
    out in q's dtype."""
    o, lse = ring_flash_fwd(q, k, v, sm_scale, _ring(ring))
    return o.to(q.dtype), lse


def _ring_setup_context(ctx, inputs, output) -> None:
    q, k, v, sm_scale, ring = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)  # JAX's residuals (q, k, v, out, lse)
    ctx.sm_scale, ctx.ring = sm_scale, ring
    ctx.mark_non_differentiable(lse)


def _ring_backward(ctx, dout: torch.Tensor, _dlse: torch.Tensor):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = ring_flash_bwd(q, k, v, out, lse, dout, ctx.sm_scale, _ring(ctx.ring))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


torch.library.register_autograd(
    "polyaxon_tpu_torch::ring_flash_attention", _ring_backward, setup_context=_ring_setup_context
)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm,
                         sm_scale: float) -> torch.Tensor:
    """Causal ring attention of this rank's shard through the kernels:
    q [B, Tl, H, d], k/v [B, Tl, Hkv, d] → [B, Tl, H, d] in q's dtype.

    The custom operator ``polyaxon_tpu_torch::ring_flash_attention`` with a
    registered autograd formula, so a ``save_attn`` checkpoint keeps its
    output and the backward's recompute runs neither an exchange nor a
    forward kernel.  On CPU tensors the kernels' plain versions run.
    """
    out, _ = _ring_flash_attention_op(q, k, v, float(sm_scale), ring_key(comm))
    return out
