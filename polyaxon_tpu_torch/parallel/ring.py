"""Ring attention: causal attention with the sequence split over the ranks of
a mesh axis.

Counterpart of ``polyaxon_tpu/parallel/ring.py``.  Each rank keeps its
query shard and the K/V blocks rotate around the ring, one hop per rank;
the softmax is accumulated online, so no rank ever holds the [T, T] scores.
JAX rotates with ``lax.ppermute`` inside ``shard_map`` over global arrays;
here each process holds its shard and the rotation is point-to-point over
the axis's ``torch.distributed`` group (:class:`GroupRing`), or, for ranks
that are threads of one process, an exchange at a barrier
(:class:`LocalRing`).

``impl="flash"`` runs the flash kernels per block
(:func:`~polyaxon_tpu_torch.parallel.flash.ring_flash_attention`),
``"dense"`` the blockwise body below, ``"auto"`` the kernels on a CUDA
tensor they take (``flash.kernel_takes``) and the dense body elsewhere.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from polyaxon_tpu_torch.parallel import flash


class GroupRing:
    """The ring over a process group: ``rotate`` sends each tensor to rank +
    1 and receives its place from rank − 1 (``reverse``: the other way).
    Both go out together through ``dist.batch_isend_irecv`` (a blocking send
    then receive would deadlock the ring); at two ranks both go to one peer.
    Without a group (an axis of size 1) the ring is one rank and rotating
    makes no call.  Gloo sends no CUDA tensor point to point ("writev ...:
    Bad address", ``tools/gloo_probe.py``): on a gloo group a CUDA tensor
    goes through a host copy each way, as ``collectives.hop`` stages it;
    NCCL takes the tensor itself.  Each send's and receive's work is waited
    once, here (a gloo send's work waited twice blocks)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None) -> None:
        self.group = group
        self.size = 1 if group is None else group.size()
        self.rank = 0 if group is None else group.rank()

    def rotate(self, tensors: Sequence[torch.Tensor], reverse: bool = False) -> Tuple:
        if self.size == 1:
            return tuple(tensors)
        step = -1 if reverse else 1
        dst, src = (self.rank + step) % self.size, (self.rank - step) % self.size
        staged = self.group.name() == "gloo"
        sent = [(t.cpu() if staged and t.is_cuda else t).contiguous() for t in tensors]
        received = [torch.empty_like(t) for t in sent]
        ops = []
        for out, into in zip(sent, received):
            ops.append(dist.P2POp(dist.isend, out, group=self.group, group_peer=dst))
            ops.append(dist.P2POp(dist.irecv, into, group=self.group, group_peer=src))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(r.to(t.device) for r, t in zip(received, tensors))


class LocalRing:
    """One rank of a ring whose ranks are threads of one process: ``rotate``
    puts this rank's tensors in its slot, waits for every rank at a barrier,
    and takes the slot of rank − 1 (``reverse``: rank + 1).

    It runs the ring's hop functions for n > 1 on one card, where two
    processes cannot share the device through NCCL: :meth:`run` starts the
    threads.  Call the hop functions (``flash.ring_flash_fwd`` /
    ``ring_flash_bwd``) from them directly, not through ``backward()``: the
    autograd engine runs a CUDA backward on one worker thread per device,
    and an exchange there waits for ranks that cannot reach it.  Every
    rank's kernels go to the thread's current stream, the device's default
    one unless the caller set another, so a tensor handed over at the
    barrier is read after the kernels that wrote it.
    """

    def __init__(self, rank: int, size: int, barrier: threading.Barrier, slots: List) -> None:
        self.rank, self.size = rank, size
        self._barrier, self._slots = barrier, slots

    @classmethod
    def run(cls, size: int, fn: Callable[["LocalRing"], Any], timeout: float = 120.0) -> List:
        """``fn(ring)`` on ``size`` threads, one rank of one ring each: the
        results in rank order.  A rank that raises breaks the barrier, so the
        others stop at their next rotation; the first error is raised here."""
        barrier, slots = threading.Barrier(size), [None] * size
        rings = [cls(r, size, barrier, slots) for r in range(size)]
        results: List = [None] * size
        errors: List[BaseException] = []

        def rank_main(r: int) -> None:
            try:
                results[r] = fn(rings[r])
            except BaseException as e:  # re-raised by the caller below
                errors.append(e)
                barrier.abort()

        threads = [threading.Thread(target=rank_main, args=(r,), name=f"ring-rank-{r}")
                   for r in range(size)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            barrier.abort()
            raise TimeoutError(f"the {size} ring ranks did not finish in {timeout} s")
        if errors:  # the rank that failed first, not one its abort stopped
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return results

    def rotate(self, tensors: Sequence[torch.Tensor], reverse: bool = False) -> Tuple:
        if self.size == 1:
            return tuple(tensors)
        src = (self.rank + (1 if reverse else -1)) % self.size
        self._slots[self.rank] = tuple(tensors)
        self._barrier.wait()
        received = self._slots[src]
        self._barrier.wait()  # every rank has read before any slot is refilled
        return received


class _Rotate(torch.autograd.Function):
    """A rotation autograd can see through: its backward sends the
    cotangents the other way round the ring."""

    @staticmethod
    def forward(ctx, comm, *tensors):
        ctx.comm = comm
        return comm.rotate(tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.comm.rotate(grads, reverse=True))


def _ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, comm) -> torch.Tensor:
    """Dense blockwise body. q/k/v: [B, Tl, H, d], contiguous sequence shards
    (K/V already broadcast to the query heads).  Differentiated by
    autograd, through :class:`_Rotate`."""
    n, idx = comm.size, comm.rank
    B, Tl, H, d = q.shape
    scale = d**-0.5
    q32 = q.float()
    ar = torch.arange(Tl, device=q.device)
    q_pos = idx * Tl + ar  # global positions of the local queries
    m = torch.full((B, H, Tl), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Tl), device=q.device)
    o = torch.zeros((B, Tl, H, d), device=q.device)
    for i in range(n):
        # After i hops along rank -> rank + 1 this rank holds block idx - i.
        k_pos = ((idx - i) % n) * Tl + ar
        s = torch.einsum("bqhd,bkhd->bhqk", q32, k.float()) * scale
        s = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # Rows masked so far keep m = -inf: guard the exp(-inf - -inf) paths.
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_new))
        p = torch.where(torch.isneginf(m_new)[..., None], 0.0, torch.exp(s - m_new[..., None]))
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha.transpose(1, 2)[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        m = m_new
        if i < n - 1:  # a last rotation would only bring the blocks home
            k, v = _Rotate.apply(comm, k, v)
    denom = torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)


def ring_attention_sharded(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, seq_axis: str, impl: str = "auto"
) -> torch.Tensor:
    """Causal attention of this rank's sequence shard over the ``seq_axis``
    ring of ``mesh``: q [B, Tl, H, d], k/v [B, Tl, Hkv, d] → [B, Tl, H, d].

    The shards are contiguous: rank r holds global positions [r·Tl,
    (r+1)·Tl).  ``impl``: ``"flash"`` the kernels per ring block (their plain
    versions on CPU tensors), ``"dense"`` the blockwise body, ``"auto"`` the
    kernels where q lies on the card and they take its shape and dtype,
    the dense body elsewhere (the JAX ring picks its kernel only on its
    accelerator).
    """
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"query heads ({q.shape[2]}) must be divisible by KV heads ({k.shape[2]}) "
            "for grouped-query attention"
        )
    if impl == "auto":
        use_kernels = q.device.type == "cuda" and flash.kernel_takes(q.shape, q.dtype)
        impl = "flash" if use_kernels else "dense"
    comm = mesh.ring(seq_axis)
    if impl == "flash":
        return flash.ring_flash_attention(q, k, v, comm, q.shape[-1] ** -0.5)
    if impl == "dense":
        # The dense body is plain MHA: broadcast the KV heads up front (the
        # flash ring broadcasts per hop, so what rotates stays Hkv-sized).
        group = q.shape[2] // k.shape[2]
        if group > 1:
            k = k.repeat_interleave(group, dim=2)
            v = v.repeat_interleave(group, dim=2)
        return _ring_attention(q, k, v, comm)
    raise ValueError(f"Unknown ring attention impl {impl!r}")
