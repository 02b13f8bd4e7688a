"""Continuous-batching generation engine over a paged KV cache.

Counterpart of ``polyaxon_tpu/serving/engine.py``: iteration-level
scheduling over block-table KV management with chunked prefill.  The engine
owns one ``[L, num_blocks, block_size, Hkv, d]`` block pool on its device,
and one scheduler thread that owns the pool.  Each scheduler iteration:

1. **admit**: move queued requests into free slots and enqueue a prefill
   job each; the shared-prefix cache maps any cached block-prefix of the
   prompt straight into the request's table (a block-aligned full hit
   copies the last block private first, copy-on-write, and recomputes only
   the final prompt token);
2. **prefill tick**: run one chunk (``prefill_chunk`` tokens) of the
   shortest pending prefill through
   :func:`~polyaxon_tpu_torch.models.decode.paged_prefill_chunk`,
   allocating table blocks lazily from the ref-counted allocator;
3. **step**: one batched decode step (or, with speculative decoding, one
   verify step over self-drafted runs) advances every active slot; a slot
   that faults a new block on an exhausted pool parks (state and blocks
   kept) and resumes when references drop;
4. **retire**: finished slots free their blocks (shared blocks drop one
   reference) and publish their prompt blocks to the prefix cache.

Greedy outputs are token-identical to sequential
:func:`~polyaxon_tpu_torch.models.decode.generate` and to the JAX engine
(``tests/test_torch_serving.py``).

The step family.  As the reference compiles a family of executables, the
engine holds one entry per step shape: the decode step (``_step_fn``), one
prefill chunk per power-of-two pad bucket (``_chunk_fns[c_pad]``: a chunk's
tokens are right-padded to ``_bucket(n)``) and one verify step per
draft-width bucket (``_verify_fns[width]``, the drafts padded to
``_width_for``; ``n_tok`` is data).  An entry's inputs are static device
buffers, filled each call by non-blocking copies from pinned host arrays.
On CUDA each entry is a CUDA graph, captured once on the scheduler thread,
all of them in one memory pool, and replayed with a single launch; on the
CPU it is the eager step bound to its key.  Sampling and the accept rule
run outside the graphs, on the device.  The COW copy is one eager op.
``start()``'s warmup builds and runs the whole family before the ready gate
opens, every write landing in trash block 0; an entry built after the gate
(``warmup=False``, or a shape the warmup missed) counts on
``serving.steady_state_compiles``.  There is no eager fallback: a capture
that fails in warmup is logged, and the request that needs the entry then
meets the error.

After the ready gate, each decode iteration calls the capture agent's
``on_step``, so a ``profile`` command on the bus traces a window of decode
steps, and the capture's ``hlo.txt`` holds the registered
``serving_decode_step``: a text naming the family's entries, whether each is
a graph, and the shapes of its static inputs and logits.

Run accounting, as the reference's: ``start()`` arms the process-wide
utilization ledger (``tracking/ledger.py``, source ``serving``); each
prefill chunk and decode step adds its wall to ``step_compute_s`` and its
emitted tokens (one on a prompt's last chunk) to the ledger's steps, and
beats the progress beacon (``tracking/flightrec.py``); ``stop()`` merges the
reference's extras (occupancy, prefix-cache and host-tier counters, sheds,
backlog, the pool's bytes and dtype, the speculation counters) and flushes
the final row.

The KV tiers.  With ``kv_offload`` a parked sequence spills its private
blocks to the host tier (:class:`~polyaxon_tpu_torch.serving.paging.HostKVTier`)
and frees them, and a cold cached prefix demotes there instead of being
evicted; with ``kv_persist_dir`` the hottest prefix blocks are saved to the
persistent store (``serving/kvstore.py``) when idle and on ``stop()``, and
the warmup preloads the newest snapshot before the ready gate opens.  On
the card a spill gathers its blocks' rows and copies them into pinned host
memory on a dedicated copy stream (ordered after the work already queued;
the whole batch dispatched, then one wait on its event), and a restore
copies pinned memory into fresh pool blocks in place on the stream the
graphs replay on: the captured entries hold the pool's addresses, so
nothing rebinds the pool.  Spill and restore run eagerly between replays,
never in a graph.

Request tracing.  A request submitted with a ``TraceContext`` records its
phases as spans under that trace id (``tracking/trace.py``): queue wait,
admission, prefix hits, prefill chunks, spill, restore, park, the first
token, sampled decode steps, and the request's root span when it ends on
any path (finished, shed, cancelled, stopped).  Phases are intervals of one
host clock read where the scheduler has already read the step's tokens
back, so a request's waterfall sums to its server-side total.

Not ported yet (ROADMAP Queue 1 item 7, its step 4): meshes and sharded
weights (raising).
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import os
import queue
import random
import threading
import time
from collections import deque
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from polyaxon_tpu_torch._device import DeviceLike, require_on, resolve_device
from polyaxon_tpu_torch.conf.knobs import knob_bool, knob_float, knob_int, knob_str
from polyaxon_tpu_torch.models import decode
from polyaxon_tpu_torch.serving import kvstore
from polyaxon_tpu_torch.serving.paging import (
    BlockAllocator,
    HostKVTier,
    PrefixCache,
    truncate_table,
)
from polyaxon_tpu_torch.stats import MemoryStats, RatioWindow
from polyaxon_tpu_torch.tracking.capture import get_capture_agent
from polyaxon_tpu_torch.tracking.flightrec import get_progress
from polyaxon_tpu_torch.tracking.ledger import get_ledger
from polyaxon_tpu_torch.tracking.trace import TraceContext, get_tracer

logger = logging.getLogger(__name__)


class EngineDrainingError(RuntimeError):
    """Raised by :meth:`ServingEngine.submit` once :meth:`drain` has been
    called: the engine finishes in-flight work but admits nothing new."""


class NgramDrafter:
    """Per-request prompt-lookup drafter (self-drafting, no draft model).

    Keeps the request's context (prompt and every accepted token) and an
    index from each ``n``-gram to the end positions of its two most recent
    occurrences.  ``draft(k)`` matches the context's last ``n`` tokens and
    proposes what followed the previous occurrence.  O(1) per appended token
    and per lookup.
    """

    __slots__ = ("n", "tokens", "_index")

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"ngram length must be positive, got {n}")
        self.n = int(n)
        self.tokens: List[int] = []
        # ngram -> (second-latest end, latest end): the context's own suffix
        # is always the latest occurrence of itself; drafting wants the one
        # before it.
        self._index: Dict[tuple, tuple] = {}

    def extend(self, toks) -> None:
        for t in toks:
            self.append(int(t))

    def append(self, tok: int) -> None:
        self.tokens.append(int(tok))
        if len(self.tokens) >= self.n:
            key = tuple(self.tokens[-self.n :])
            prev = self._index.get(key)
            self._index[key] = (prev[1] if prev else None, len(self.tokens))

    def draft(self, k: int) -> List[int]:
        """Up to ``k`` proposed continuation tokens ([] = no match)."""
        t = self.tokens
        if k < 1 or len(t) < self.n:
            return []
        ends = self._index.get(tuple(t[-self.n :]))
        if ends is None:
            return []
        end = ends[1] if ends[1] < len(t) else ends[0]
        if end is None:
            return []
        return t[end : end + k]


class _RequestTrace:
    """Per-request distributed-trace state.

    ``ctx`` is the propagated :class:`TraceContext` (one trace id across
    router, replica and engine); ``root_id`` is the engine-side request span
    every phase span parents to.  ``park_s`` accumulates the time spent
    parked, so the waterfall splits decode time from capacity stalls.  The
    phases are intervals (queue wait, prefill, decode and parked partition
    the request's wall clock), so the waterfall sums to the server-side
    total however many hot spans were sampled away.
    """

    __slots__ = ("ctx", "root_id", "parked_at", "park_s", "ttft_s")

    def __init__(self, ctx: TraceContext, root_id: str) -> None:
        self.ctx = ctx
        self.root_id = root_id
        self.parked_at: Optional[float] = None
        self.park_s = 0.0
        self.ttft_s: Optional[float] = None


class _SlowExemplars:
    """Bounded ring of the ``n`` slowest fully traced requests in a sliding
    window: ``offer`` keeps the slowest finished-request summaries whose
    finish time falls in the window, ``snapshot`` returns them slowest
    first (``/v1/stats``'s ``trace_exemplars``)."""

    def __init__(self, n: int, window_s: float) -> None:
        self.n = int(n)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._entries: List[Dict[str, Any]] = []

    def offer(self, summary: Dict[str, Any]) -> None:
        if self.n <= 0:
            return
        now = time.time()
        with self._lock:
            self._entries = [
                e for e in self._entries if now - e.get("finished_at", now) <= self.window_s
            ]
            self._entries.append(summary)
            self._entries.sort(key=lambda e: e.get("total_s", 0.0), reverse=True)
            del self._entries[self.n:]

    def snapshot(self) -> List[Dict[str, Any]]:
        now = time.time()
        with self._lock:
            return [
                dict(e) for e in self._entries if now - e.get("finished_at", now) <= self.window_s
            ]


class GenerationRequest:
    """One queued generation: its prompt, its budget, and its results.

    ``stream`` yields token ids as they are generated (a ``None`` sentinel
    marks completion); ``done`` is set when the request has finished or
    failed (``error``; ``error_kind`` is ``shed``, ``cancelled`` or
    ``stopped``).  ``tokens`` accumulates the generated ids in order.
    """

    _ids = itertools.count()

    def __init__(self, prompt: List[int], max_new_tokens: int, temperature: float = 0.0) -> None:
        self.id = next(self._ids)
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.tokens: List[int] = []
        self.stream: "queue.Queue[Optional[int]]" = queue.Queue()
        self.done = threading.Event()
        self.error: Optional[str] = None
        self.error_kind: Optional[str] = None
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        #: Distributed-trace state (None: an untraced request).
        self.trace: Optional[_RequestTrace] = None
        #: The latency waterfall, filled once when the request ends.
        self.trace_summary: Optional[Dict[str, Any]] = None

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        """Block until done; raise on engine-side failure."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} still running")
        if self.error:
            raise RuntimeError(self.error)
        return self.tokens


class SlotAllocator:
    """FIFO free-list over ``n`` batch slots: freed slots go to the back, so
    reuse order is release order."""

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"need at least one slot, got {n}")
        self.n = n
        self._free: deque = deque(range(n))
        self._held: set = set()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.popleft()
        self._held.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._held:
            raise ValueError(f"slot {slot} is not allocated")
        self._held.discard(slot)
        self._free.append(slot)

    @property
    def n_active(self) -> int:
        return len(self._held)


class _PrefillJob:
    """One admitted request's remaining prompt insertion, advanced one chunk
    per scheduler iteration."""

    __slots__ = ("req", "slot", "next_pos", "cow_pending")

    def __init__(self, req: GenerationRequest, slot: int) -> None:
        self.req = req
        self.slot = slot
        self.next_pos = 0  # first prompt position not yet inserted
        self.cow_pending = False  # full prefix hit: copy the last block first


def _not_ported(name: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"ServingEngine {name} is not ported yet (ROADMAP: {item})")


_NP_DTYPES = {torch.int64: np.int64, torch.bool: np.bool_, torch.float32: np.float32}


def _pinned(arr, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``, in pinned memory when it is
    bound for the card (so the copy can be asynchronous)."""
    t = torch.from_numpy(np.asarray(arr, dtype=_NP_DTYPES[dtype]))
    return t.pin_memory() if device.type == "cuda" else t


def _tree_leaves(tree: Any, path: str = "") -> List[tuple]:
    """``(path, tensor)`` for every leaf of a weight tree (dicts in sorted
    key order, lists and tuples in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in _tree_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


class _StepEntry:
    """One member of the engine's step family: a step bound to its key, its
    static input buffers and, when captured, its CUDA graph.

    ``fn(**inputs)`` returns float32 logits.  The buffers start as zeros,
    which make every step write only trash block 0 (tables of block 0, no
    active lane, chunk length 0), so the capture's warm-up runs are harmless.
    A call copies its host arrays into the buffers and replays the graph (or
    runs ``fn``) and returns the logits: with a graph, the one static output
    buffer, which the caller reads before any other entry replays (entries
    share one memory pool).
    """

    def __init__(self, fn: Callable[..., torch.Tensor], inputs: Dict[str, torch.Tensor],
                 capture: bool, pool=None) -> None:
        self.fn = fn
        self.inputs = inputs
        self.graph = None
        self.out: Optional[torch.Tensor] = None
        if capture:
            self.graph, self.out = decode.capture_step(lambda: fn(**inputs), pool=pool)

    @torch.inference_mode()
    def __call__(self, **host) -> torch.Tensor:
        for name, arr in host.items():
            buf = self.inputs[name]
            buf.copy_(_pinned(arr, buf.dtype, buf.device), non_blocking=True)
        if self.graph is None:
            return self.fn(**self.inputs)
        self.graph.replay()
        return self.out


class ServingEngine:
    """The continuous-batching scheduler: one thread owns the device.

    Parameters match the reference's (see its docstring for each): ``slots``,
    ``max_len`` (default ``cfg.max_seq``), ``block_size``, ``num_blocks``
    (default ``1 + slots * ceil(max_len / block_size)``, the trash block
    included), ``prefill_chunk`` (``None`` = whole prompts), ``prefix_cache``,
    ``qweights`` (from ``decode.quantize_weights``), ``kv_quantize``
    (``"int8"`` pool), ``eos_id``, ``seed``, ``stats`` (a ``MemoryStats``;
    default a private one), ``warmup`` (default the
    ``POLYAXON_TPU_SERVING_WARMUP`` knob), ``spec_decode`` / ``spec_k`` /
    ``spec_min_ngram`` (default the ``POLYAXON_TPU_SERVING_SPEC_*`` knobs).
    ``device`` (default ``cuda``; raises without a card) is where the pool
    lives; ``params`` and ``qweights`` must already lie there.

    Sampling (temperature > 0) draws Gumbel noise from one
    ``torch.Generator`` seeded from ``seed``, a row per slot, so a slot's
    draw does not depend on its neighbours' logits.

    ``kv_offload`` / ``kv_offload_blocks`` (default the
    ``POLYAXON_TPU_KV_OFFLOAD*`` knobs) arm the host tier: parked sequences
    spill their private blocks, cold prefixes demote (``kv_offload_blocks``
    bounds the demoted population, 0 = unbounded; spills are pinned and
    never count).  ``kv_persist_dir`` / ``kv_persist_blocks`` /
    ``kv_persist_sig`` (default the ``POLYAXON_TPU_KV_PERSIST_*`` knobs) arm
    the persistent prefix store; an empty ``kv_persist_sig`` is derived from
    the weights, and persistence turns off when that fails.  A traced
    request (``submit(..., trace=)``, while ``trace_requests``, default the
    ``POLYAXON_TPU_TRACE_REQUESTS`` knob) records its phases as spans.
    ``mesh``, ``param_shardings`` and ``qweights_shardings`` raise
    ``NotImplementedError`` unless left at their defaults.
    """

    #: Padding buckets for prompt chunks: powers of two bound the number of
    #: chunk entries at log2(max_len) whatever the traffic.
    @staticmethod
    def _bucket(t: int, max_len: int) -> int:
        b = 8
        while b < t:
            b *= 2
        return min(b, max_len)

    def __init__(
        self,
        params: Any,
        cfg: Any,
        *,
        slots: int = 4,
        max_len: Optional[int] = None,
        block_size: int = 16,
        num_blocks: Optional[int] = None,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = True,
        qweights: Optional[Any] = None,
        kv_quantize: Optional[str] = None,
        mesh: Any = None,
        param_shardings: Optional[Any] = None,
        qweights_shardings: Optional[Any] = None,
        eos_id: Optional[int] = None,
        seed: int = 0,
        stats: Optional[Any] = None,
        warmup: Optional[bool] = None,
        spec_decode: Optional[bool] = None,
        spec_k: Optional[int] = None,
        spec_min_ngram: Optional[int] = None,
        kv_offload: Optional[bool] = None,
        kv_offload_blocks: Optional[int] = None,
        kv_persist_dir: Optional[str] = None,
        kv_persist_blocks: Optional[int] = None,
        kv_persist_sig: str = "",
        device: DeviceLike = "cuda",
        _eager: bool = False,
    ) -> None:
        for name, value in (("mesh", mesh), ("param_shardings", param_shardings),
                            ("qweights_shardings", qweights_shardings)):
            if value is not None:
                raise _not_ported(name, "Queue 1 item 7, multi-process and parallelism")
        self.device = resolve_device(device)
        require_on(self.device, embed=params["embed"])
        if qweights is not None:
            require_on(self.device, qweights=qweights["unembed"][0])
        if max_len is None:
            max_len = cfg.max_seq
        if max_len > cfg.max_seq:
            raise ValueError(
                f"max_len ({max_len}) exceeds the model's max_seq ({cfg.max_seq})"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be positive, got {block_size}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be positive or None, got {prefill_chunk}")
        self.cfg = cfg
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.block_size = int(block_size)
        self.prefill_chunk = prefill_chunk
        self.eos_id = eos_id
        # Compute-dtype weight copies, made once for every step of the family.
        self._params = decode.cast_weights(params, cfg)
        self._qweights = qweights

        # Table width: logical blocks a max_len sequence spans.  The default
        # pool lets every slot reach max_len unshared, plus the trash block.
        self._table_width = -(-self.max_len // self.block_size)
        if num_blocks is None:
            num_blocks = 1 + self.slots * self._table_width
        self.block_allocator = BlockAllocator(num_blocks)
        self.prefix_cache = (
            PrefixCache(self.block_allocator, self.block_size) if prefix_cache else None
        )
        kvq = "" if kv_quantize in (None, False) else str(kv_quantize).lower()
        if kvq in ("", "0", "false", "no", "off", "none"):
            self.kv_quantize: Optional[str] = None
        elif kvq in ("1", "true", "yes", "on", "int8"):
            self.kv_quantize = "int8"
        else:
            raise ValueError(f"unsupported kv_quantize {kv_quantize!r} (int8 or off)")
        self._pool = decode.init_block_pool(
            cfg, num_blocks, self.block_size, kv_dtype=self.kv_quantize, device=self.device
        )
        #: What the pool leaves store ("int8" or the compute dtype's name) and
        #: their device bytes, on ``/v1/stats`` and the kv_pool_bytes gauge.
        self.kv_dtype = self.kv_quantize or str(cfg.dtype).replace("torch.", "")
        self.kv_pool_bytes = int(
            sum(t.numel() * t.element_size() for t in self._pool.values())
        )
        # Per-slot block tables (host truth): -1 = unset, sent to the device
        # as the trash block.
        self._tables = np.full((self.slots, self._table_width), -1, np.int32)

        # Host-side per-slot state: the next token to feed, its absolute
        # position, the active mask, and each slot's sampling temperature.
        self._tok = np.zeros(self.slots, np.int32)
        self._pos = np.zeros(self.slots, np.int32)
        self._active = np.zeros(self.slots, bool)
        self._temps = np.zeros(self.slots, np.float32)
        self._slot_req: List[Optional[GenerationRequest]] = [None] * self.slots

        self.allocator = SlotAllocator(self.slots)
        self._queue: "deque[GenerationRequest]" = deque()
        self._prefill: "deque[_PrefillJob]" = deque()
        self._parked: List[int] = []
        self._cancels: set = set()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._draining = False
        self._thread: Optional[threading.Thread] = None

        # Warmup / readiness gate: the scheduler thread runs each shape once
        # before its first iteration; requests submitted meanwhile queue.
        if warmup is None:
            warmup = knob_bool("POLYAXON_TPU_SERVING_WARMUP")
        self._warmup = bool(warmup)
        self._ready = threading.Event()
        self._warmup_total = 0
        self._warmup_done = 0
        self._warmup_s = 0.0

        # The step family (module docstring).  ``_eager`` runs the entries
        # without capture on CUDA too: a private switch for the comparisons
        # of graph against eager, not a mode of the reference.
        self._graphs = self.device.type == "cuda" and not _eager
        self._graph_pool = torch.cuda.graph_pool_handle() if self._graphs else None
        self._step_fn: Optional[_StepEntry] = None
        self._chunk_fns: Dict[int, _StepEntry] = {}
        self._verify_fns: Dict[int, _StepEntry] = {}
        self._n_steady_compiles = 0
        self._compiled_baseline: Optional[int] = None

        # Speculative decoding: self-drafted multi-token steps.
        if spec_decode is None:
            spec_decode = knob_bool("POLYAXON_TPU_SERVING_SPEC_DECODE")
        self.spec_decode = bool(spec_decode)
        self.spec_k = int(spec_k if spec_k is not None else knob_int("POLYAXON_TPU_SERVING_SPEC_K"))
        self.spec_min_ngram = int(
            spec_min_ngram if spec_min_ngram is not None
            else knob_int("POLYAXON_TPU_SERVING_SPEC_MIN_NGRAM")
        )
        if self.spec_decode and self.spec_k < 1:
            raise ValueError(f"spec_k must be positive, got {self.spec_k}")
        if self.spec_decode and self.spec_min_ngram < 1:
            raise ValueError(f"spec_min_ngram must be positive, got {self.spec_min_ngram}")
        #: Per-slot drafter (None: slot empty, spec off, or a sampled request).
        self._drafters: List[Optional[NgramDrafter]] = [None] * self.slots
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_fallbacks = 0
        self._spec_steps = 0

        # The KV tiers: the host offload tier and the persistent prefix
        # store, both defaulting from the POLYAXON_TPU_KV_* knobs.
        if kv_offload is None:
            kv_offload = knob_bool("POLYAXON_TPU_KV_OFFLOAD")
        self.kv_offload = bool(kv_offload)
        self.kv_offload_blocks = int(
            kv_offload_blocks if kv_offload_blocks is not None
            else knob_int("POLYAXON_TPU_KV_OFFLOAD_BLOCKS")
        )
        if kv_persist_dir is None:
            kv_persist_dir = knob_str("POLYAXON_TPU_KV_PERSIST_DIR")
        self.kv_persist_dir = str(kv_persist_dir) if kv_persist_dir else None
        self.kv_persist_blocks = int(
            kv_persist_blocks if kv_persist_blocks is not None
            else knob_int("POLYAXON_TPU_KV_PERSIST_BLOCKS")
        )
        self.kv_persist_sig = str(kv_persist_sig or "")
        if self.kv_persist_dir and not self.kv_persist_sig:
            # Geometry cannot tell two checkpoints of one config apart, and
            # an unsigned shared store could serve another model's KV: sign
            # with a fingerprint of the weights, or do not persist.
            self.kv_persist_sig = self._auto_persist_sig(params, qweights, seed)
            if not self.kv_persist_sig:
                logger.warning("kv_persist_dir is set but no kv_persist_sig was given and no "
                               "weight fingerprint could be derived: KV persistence is off")
                self.kv_persist_dir = None
        self._kv_persist_interval_s = knob_float("POLYAXON_TPU_KV_PERSIST_INTERVAL_S")
        self._host_tier = HostKVTier(self.kv_offload_blocks) if self.kv_offload else None
        #: Parked-sequence spill map: slot -> {table index: tier handle}.
        self._spilled: Dict[int, Dict[int, int]] = {}
        self._n_spilled_blocks = 0
        self._n_restored_blocks = 0
        self._kv_preloaded_blocks = 0
        self._kv_persisted_blocks = 0
        self._last_persist_t = 0.0
        self._last_persist_mut = -1
        # On the card: the spill copies' own stream (made at first use), the
        # restores still in flight with the pinned payloads they read (kept
        # alive until their copies end), and the copies' bytes and times.
        self._copy_stream: Optional[torch.cuda.Stream] = None
        self._restores_in_flight: "deque[tuple]" = deque()
        self._copy_clock = {kind: {"blocks": 0, "bytes": 0, "copy_s": 0.0, "host_s": 0.0}
                            for kind in ("spill", "restore")}
        if self._host_tier is not None and self.prefix_cache is not None:
            self.prefix_cache.attach_tier(
                self._host_tier,
                spill=self._spill_to_tier,
                restore=self._restore_from_tier,
                alloc=self._alloc_block,
            )

        # The event the scheduler's reads of step results poll (``_to_host``).
        self._read_done = torch.cuda.Event() if self.device.type == "cuda" else None
        self._generator = torch.Generator(device=self.device).manual_seed(int(seed))

        # Stats: lifetime counters plus a sliding window for tokens/s; latency
        # distributions go to the (possibly shared) histogram registry.
        self.stats_registry = stats if stats is not None else MemoryStats()
        self._stats_lock = threading.Lock()
        self._n_submitted = 0
        self._n_finished = 0
        self._n_cancelled = 0
        self._n_shed = 0
        self._n_tokens = 0
        self._n_steps = 0
        # On-demand capture (`profile` commands): a window of decode steps,
        # gated on the ready event so warmup steps never open one.
        self._capture = get_capture_agent()
        self._progress = get_progress()
        #: The utilization ledger while started (armed by start()).
        self._ledger: Optional[Any] = None
        self._n_parks = 0
        self._n_cow = 0
        self._backlog_chunks = 0
        self._prefill_jobs = 0
        self._window: "deque[tuple]" = deque()  # (t, n_tokens)
        # Windowed variants of the lifetime ratios; horizon 2x so the
        # baseline sample at or before the window start survives.
        self._stats_window_s = knob_float("POLYAXON_TPU_SERVING_STATS_WINDOW_S")
        self._pc_window = RatioWindow(self._stats_window_s * 2.0)
        self._spec_window = RatioWindow(self._stats_window_s * 2.0)
        # Request tracing: the master switch and the slow-request exemplars.
        self.trace_requests = knob_bool("POLYAXON_TPU_TRACE_REQUESTS")
        self._exemplars = _SlowExemplars(
            knob_int("POLYAXON_TPU_TRACE_EXEMPLARS"),
            knob_float("POLYAXON_TPU_TRACE_EXEMPLAR_WINDOW_S"),
        )
        # Device-busy seconds (prefill chunks and steps, host sync included)
        # and their occupancy-weighted sum, since start().
        self._started_at: Optional[float] = None
        self._busy_s = 0.0
        self._occ_weighted_s = 0.0

    # -- the step family ------------------------------------------------------

    def _entry(self, fn: Callable[..., torch.Tensor], **shapes) -> _StepEntry:
        """A new family member over zeroed static buffers: ``shapes`` maps each
        input name to (shape, dtype)."""
        with torch.inference_mode():
            inputs = {name: torch.zeros(shape, dtype=dtype, device=self.device)
                      for name, (shape, dtype) in shapes.items()}
            return _StepEntry(fn, inputs, self._graphs, self._graph_pool)

    def _get_step(self) -> _StepEntry:
        if self._step_fn is None:
            S, W = self.slots, self._table_width
            self._step_fn = self._entry(
                lambda tables, tokens, pos, active: decode.paged_decode_step(
                    self._params, self._pool, tables, tokens, pos, active, self.cfg,
                    qweights=self._qweights)[0],
                tables=((S, W), torch.int64), tokens=((S,), torch.int64),
                pos=((S,), torch.int64), active=((S,), torch.bool),
            )
        return self._step_fn

    def _get_chunk(self, c_pad: int) -> _StepEntry:
        if c_pad not in self._chunk_fns:
            self._chunk_fns[c_pad] = self._entry(
                lambda table, tokens, start, length: decode.paged_prefill_chunk(
                    self._params, self._pool, table, tokens, start, length, self.cfg)[0],
                table=((self._table_width,), torch.int64), tokens=((c_pad,), torch.int64),
                start=((), torch.int64), length=((), torch.int64),
            )
        return self._chunk_fns[c_pad]

    def _spec_widths(self) -> List[int]:
        """The verify-step width family: draft-count buckets (powers of two
        capped at ``spec_k``) plus one row for the current token; ``n_tok`` is
        data inside each bucket."""
        if not self.spec_decode:
            return []
        out = set()
        k = 1
        while k < self.spec_k:
            out.add(k + 1)
            k *= 2
        out.add(self.spec_k + 1)
        return sorted(out)

    def _width_for(self, max_draft: int) -> int:
        """Smallest verify width that fits ``max_draft`` drafts."""
        for w in self._spec_widths():
            if w >= max_draft + 1:
                return w
        return self.spec_k + 1

    def _get_verify(self, width: int) -> _StepEntry:
        if width not in self._verify_fns:
            S, W = self.slots, self._table_width
            self._verify_fns[width] = self._entry(
                lambda tables, tokens, pos, n_tok, active: decode.paged_verify_step(
                    self._params, self._pool, tables, tokens, pos, n_tok, active, self.cfg,
                    qweights=self._qweights)[0],
                tables=((S, W), torch.int64), tokens=((S, width), torch.int64),
                pos=((S,), torch.int64), n_tok=((S,), torch.int64), active=((S,), torch.bool),
            )
        return self._verify_fns[width]

    def _compiled_count(self) -> int:
        """Entries of the step family built so far."""
        return int(self._step_fn is not None) + len(self._chunk_fns) + len(self._verify_fns)

    def _warmup_buckets(self) -> List[int]:
        """The chunk buckets live traffic can need: every ``_bucket`` value for
        chunk lengths up to ``prefill_chunk`` (the whole prompt when
        unchunked), capped at ``max_len``."""
        cap = min(self.prefill_chunk or self.max_len, self.max_len)
        out = set()
        b = 8
        while True:
            out.add(min(b, self.max_len))
            if b >= cap:
                break
            b *= 2
        return sorted(out)

    def _check_steady_compiles(self) -> None:
        """Entries built after the ready gate stalled a batch for their
        capture: count them on ``serving.steady_state_compiles``."""
        if self._compiled_baseline is None:
            return
        n = self._compiled_count()
        grew = n - self._compiled_baseline
        if grew <= 0:
            return
        self._compiled_baseline = n
        with self._stats_lock:
            self._n_steady_compiles += grew
        self.stats_registry.incr("serving.steady_state_compiles", grew)
        with get_tracer().span("engine.compile", n=grew, total=n):
            pass

    # -- device calls ----------------------------------------------------------

    def _table_array(self) -> np.ndarray:
        """The block tables with unset entries sent as the trash block."""
        return np.where(self._tables >= 0, self._tables, 0)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray) -> torch.Tensor:
        """Per row: argmax where ``temps <= 0``, else a draw from
        ``softmax(logits / temp)`` by the Gumbel-max rule, each row from its
        own row of noise."""
        greedy = logits.argmax(dim=-1)
        if not (temps > 0).any():
            return greedy
        t = self._temps_on_device(temps)
        safe = torch.where(t > 0, t, torch.ones_like(t))
        u = torch.rand(logits.shape, generator=self._generator, device=self.device)
        sampled = (logits / safe[:, None] - torch.log(-torch.log(u))).argmax(dim=-1)
        return torch.where(t > 0, sampled, greedy)

    def _temps_on_device(self, temps: np.ndarray) -> torch.Tensor:
        return _pinned(temps, torch.float32, self.device).to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _decode(self) -> torch.Tensor:
        """One paged decode step over every slot → next tokens [S] (0 for
        inactive lanes), still on the device."""
        step = self._get_step()
        logits = step(tables=self._table_array(), tokens=self._tok, pos=self._pos,
                      active=self._active)
        return torch.where(step.inputs["active"], self._sample(logits, self._temps), 0)

    @torch.inference_mode()
    def _verify(self, tok_in: np.ndarray, n_tok: np.ndarray):
        """One verify step (``tok_in`` [S, width], a width of the family) plus
        the accept rule → (tokens [S, width], emit counts [S]) as one host
        array [S, width + 1] (the loop's one device read)."""
        step = self._get_verify(tok_in.shape[1])
        logits = step(tables=self._table_array(), tokens=tok_in, pos=self._pos, n_tok=n_tok,
                      active=self._active)
        tokens, n, active = step.inputs["tokens"], step.inputs["n_tok"], step.inputs["active"]
        greedy = logits.argmax(dim=-1)
        # Row 0 is always emitted; sampled lanes (which never draft) sample it
        # exactly like the single-token step.
        first = self._sample(logits[:, 0], self._temps)
        out = torch.cat([first[:, None], greedy[:, 1:]], dim=1)
        # Draft j+1 survives iff it equals the model's pick after row j and
        # every draft before it survived (cumprod): the greedy accept rule.
        temps = self._temps_on_device(self._temps)
        drafts_ok = (torch.arange(1, tokens.shape[1], device=self.device)[None, :]
                     < n[:, None]) & (temps[:, None] <= 0)
        match = (tokens[:, 1:] == greedy[:, :-1]) & drafts_ok
        n_emit = 1 + torch.cumprod(match.long(), dim=1).sum(dim=1)
        out = torch.where(active[:, None], out, 0)
        n_emit = torch.where(active, n_emit, 0)
        return self._to_host(torch.cat([out, n_emit[:, None]], dim=1))

    @torch.inference_mode()
    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        """A step's result as a host array.  On the card it is copied into
        pinned memory, and until the copy lands the scheduler polls an event
        and yields its core between polls: a synchronous copy spins on the
        core, and a thread the scheduler has just woken (an ``lm_server``
        handler or a client waiting on a finished request) can be queued
        behind that spin."""
        if self._read_done is None:
            return t.numpy()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        self._read_done.record()
        while not self._read_done.query():
            os.sched_yield()
        return host.numpy()

    @torch.inference_mode()
    def _chunk(self, table: np.ndarray, chunk: np.ndarray, start: int) -> torch.Tensor:
        """One prompt chunk, right-padded to its bucket → logits of its last
        real token [vocab]."""
        n = len(chunk)
        tokens = np.zeros(self._bucket(n, self.max_len), np.int64)
        tokens[:n] = chunk
        return self._get_chunk(len(tokens))(table=table, tokens=tokens, start=start, length=n)

    # -- the host tier's copies ------------------------------------------------

    @torch.inference_mode()
    def _export_blocks(self, blocks: List[int]) -> List[Dict[str, torch.Tensor]]:
        """Device-to-host copies of ``blocks``' payloads (``{leaf: [L, bs,
        ...]}`` in the pool's storage dtypes).

        On the card the whole batch is dispatched before the one wait: per
        pool leaf, each block's rows copied into one device staging buffer
        (plain strided copies, whatever the batch's size) and one
        non-blocking copy of it into a pinned buffer (allocated first), on
        the copy stream, which first waits for the work already queued on
        the scheduler's stream (the steps that wrote the rows).  The host then waits on the copies'
        event, so the payloads are whole when they enter the tier, and a
        block freed after this returns cannot be overwritten under its copy;
        the scheduler's stream also waits on that event.  Block ``i``'s
        payload is row ``i`` of each pinned buffer."""
        if self.device.type != "cuda":
            return [decode.export_block(self._pool, b) for b in blocks]
        current = torch.cuda.current_stream(self.device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        stream = self._copy_stream
        shapes = {name: (len(blocks),) + leaf.shape[:1] + leaf.shape[2:]
                  for name, leaf in self._pool.items()}
        staged = {name: torch.empty(shapes[name], dtype=leaf.dtype, pin_memory=True)
                  for name, leaf in self._pool.items()}
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            rows = {name: torch.empty(shapes[name], dtype=leaf.dtype, device=self.device)
                    for name, leaf in self._pool.items()}
            start.record(stream)
            for name, leaf in self._pool.items():
                for i, b in enumerate(blocks):
                    rows[name][i].copy_(leaf[:, b])
                staged[name].copy_(rows[name], non_blocking=True)
            done.record(stream)
        current.wait_event(done)
        done.synchronize()
        clock = self._copy_clock["spill"]
        clock["blocks"] += len(blocks)
        clock["bytes"] += sum(t.nbytes for t in staged.values())
        clock["copy_s"] += start.elapsed_time(done) / 1e3
        return [{name: buf[i] for name, buf in staged.items()} for i in range(len(blocks))]

    @torch.inference_mode()
    def _copy_in(self, blocks: List[int], payloads: List[Dict[str, torch.Tensor]]) -> None:
        """Write ``payloads[i]`` into pool block ``blocks[i]`` in place (the
        captured entries hold the pool's addresses).  On the card, on the
        current stream, the one the graphs replay on, so the next replay is
        ordered after the writes: per pool leaf, non-blocking copies from
        pinned memory into one device staging buffer, then a strided copy of
        each block's rows into the pool.  Payloads not in pinned memory (a store's) are stacked into
        one pinned buffer a leaf first.  The sources stay referenced until
        the copies' event has passed."""
        if self.device.type != "cuda":
            for block, data in zip(blocks, payloads):
                decode.import_block(self._pool, data, block)
            return
        while self._restores_in_flight and self._restores_in_flight[0][1].query():
            self._retire_restore(*self._restores_in_flight.popleft())
        current = torch.cuda.current_stream(self.device)
        stacked = {}  # leaf -> one pinned buffer of the batch's rows
        for name in self._pool:
            leaves = [data[name] for data in payloads]
            if not all(t.is_pinned() for t in leaves):
                stacked[name] = torch.stack(leaves).pin_memory()
        rows = {name: torch.empty((len(blocks),) + leaf.shape[:1] + leaf.shape[2:],
                                  dtype=leaf.dtype, device=self.device)
                for name, leaf in self._pool.items()}
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        start.record(current)
        for name, leaf in self._pool.items():
            if name in stacked:
                rows[name].copy_(stacked[name], non_blocking=True)
            else:
                for i, data in enumerate(payloads):
                    rows[name][i].copy_(data[name], non_blocking=True)
            for i, b in enumerate(blocks):
                leaf[:, b].copy_(rows[name][i])
        done.record(current)
        self._restores_in_flight.append((start, done, payloads, stacked))

    def _retire_restore(self, start, done, payloads, stacked) -> None:
        clock = self._copy_clock["restore"]
        clock["blocks"] += len(payloads)
        clock["bytes"] += sum(t.nbytes for data in payloads for t in data.values())
        clock["copy_s"] += start.elapsed_time(done) / 1e3

    def _copy_figures(self) -> Dict[str, Dict[str, float]]:
        """The spill and restore copies so far: blocks, bytes, device seconds
        between each batch's copy events, and the host seconds a park spill
        and a parked slot's restore held the scheduler (waits for the
        restores still in flight)."""
        while self._restores_in_flight:
            restore = self._restores_in_flight.popleft()
            restore[1].synchronize()
            self._retire_restore(*restore)
        return {kind: dict(v) for kind, v in self._copy_clock.items()}

    def _import_blocks(self, blocks: List[int], payloads: List[Dict[str, torch.Tensor]]) -> None:
        """Host-to-device copies of payloads into pool blocks."""
        self._copy_in(blocks, payloads)
        with self._stats_lock:
            self._n_restored_blocks += len(blocks)

    def _spill_to_tier(self, block: int) -> Optional[int]:
        """PrefixCache demotion callback: move one cached block's payload to
        the host; returns its tier handle (None: the tier refused, and the
        entry is evicted instead)."""
        [data] = self._export_blocks([block])
        handle = self._host_tier.put(data, pinned=False)
        if handle is not None:
            with self._stats_lock:
                self._n_spilled_blocks += 1
        return handle

    def _restore_from_tier(self, handle: int, block: int) -> None:
        """PrefixCache restore callback: write a demoted entry's payload back
        into the freshly allocated block."""
        self._import_blocks([block], [self._host_tier.pop(handle)])

    def _run_warmup(self) -> None:
        """Build and run the whole step family before serving (scheduler
        thread, before its first iteration), with all writes landing in trash
        block 0: the decode step with no active lane, each chunk bucket with
        ``length=0``, each verify width all-inactive, the COW copy as a trash
        self-copy, and with a tier or a store armed one export and import of
        block 0.  A persisted prefix store is preloaded first.  A failure is
        logged and the gate opens regardless: the first request that needs
        the entry then meets the error."""
        tracer = get_tracer()
        t0 = time.perf_counter()
        # Warm boot: fill the prefix cache from the persisted store before
        # the gate opens.  A missing, torn or mismatched store boots cold.
        try:
            self._preload_prefixes()
        except Exception:
            logger.exception("prefix store preload failed; booting cold")
        spillers = self._host_tier is not None or bool(self.kv_persist_dir)
        buckets = self._warmup_buckets() if self._warmup else []
        widths = self._spec_widths() if self._warmup else []
        self._warmup_total = (len(buckets) + len(widths) + 2 + (1 if spillers else 0)
                              if self._warmup else 0)
        gauge = self.stats_registry.gauge

        def _tick() -> None:
            self._warmup_done += 1
            gauge("serving.warmup_progress", self._warmup_done / self._warmup_total)

        try:
            if self._warmup:
                with tracer.span("serving.warmup", buckets=len(buckets)):
                    self._decode().cpu()
                    _tick()
                    table0 = np.zeros(self._table_width, np.int64)
                    for c_pad in buckets:
                        if self._stop.is_set():
                            break
                        self._get_chunk(c_pad)(table=table0, tokens=np.zeros(c_pad, np.int64),
                                               start=0, length=0).cpu()
                        _tick()
                    for width in widths:
                        if self._stop.is_set():
                            break
                        self._verify(np.zeros((self.slots, width), np.int64),
                                     np.ones(self.slots, np.int64))
                        _tick()
                    self._pool = decode.copy_block(self._pool, 0, 0)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    _tick()
                    if spillers:
                        # A spill and restore round trip through the trash
                        # block: the copy stream and the pinned buffers are
                        # made before the first park or demotion.
                        [data] = self._export_blocks([0])
                        self._copy_in([0], [data])
                        self._copy_figures()
                        for clock in self._copy_clock.values():
                            clock.update(blocks=0, bytes=0, copy_s=0.0, host_s=0.0)
                        _tick()
        except Exception:
            logger.exception("serving engine warmup failed")
        finally:
            self._warmup_s = time.perf_counter() - t0
            self._compiled_baseline = self._compiled_count()
            # Rendered only if a profile command fires.
            self._capture.register_executable(
                "serving_decode_step", SimpleNamespace(as_text=self._family_text))
            self._ready.set()
            gauge("serving.warmup_progress", 1.0)

    def _family_text(self) -> str:
        """The step family as text (a capture's ``hlo.txt``): each entry, a
        CUDA graph or eager, with its static inputs' and logits' shapes."""
        entries = [("decode", self._step_fn)]
        entries += [(f"chunk[{c}]", e) for c, e in sorted(self._chunk_fns.items())]
        entries += [(f"verify[{w}]", e) for w, e in sorted(self._verify_fns.items())]
        lines = [f"// serving step family on {self.device}: {self.slots} slots, "
                 f"{self.block_allocator.num_blocks} blocks of {self.block_size}, "
                 f"kv {self.kv_dtype}"]
        for name, entry in entries:
            if entry is None:
                continue
            ins = ", ".join(f"{k} {list(t.shape)} {str(t.dtype).replace('torch.', '')}"
                            for k, t in entry.inputs.items())
            kind = "cuda graph" if entry.graph is not None else "eager"
            out = f"logits {list(entry.out.shape)}" if entry.out is not None else ""
            lines.append(f"{name}: {kind}; inputs {ins}; {out}".rstrip("; "))
        return "\n".join(lines)

    # -- public API ------------------------------------------------------------

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until the warmup pass has run (or was skipped or failed)."""
        return self._ready.wait(timeout)

    def start(self) -> "ServingEngine":
        if self._thread is None:
            self._ledger = get_ledger().start(source="serving", device=self.device)
            self._started_at = time.time()
            self._thread = threading.Thread(target=self._loop, name="serving-engine", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the scheduler; every request still pending gets its error
        and exactly one ``None`` stream sentinel (queued, mid-prefill,
        parked or decoding alike)."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # The final prefix-store snapshot (the scheduler is down, the pool is
        # this thread's): whatever this replica learned, the next one boots with.
        self._maybe_persist(force=True)
        if self._ledger is not None:
            paging = self._paging_snapshot()
            spec = self._spec_snapshot()
            self._ledger.merge_extra(
                **self._utilization_snapshot(),
                **{k: paging[k] for k in (
                    "block_occupancy", "prefix_cache_hit_rate", "prefix_cache_hits",
                    "prefix_cache_misses", "prefix_cache_evictions", "prefix_cache_demotions",
                    "prefix_cache_restores", "parked_sequences", "requests_shed",
                    "host_spilled_blocks_total", "host_restored_blocks_total",
                    "prefill_backlog_chunks", "kv_pool_bytes", "kv_dtype")},
                **{k: spec[k] for k in (
                    "spec_proposed_total", "spec_accepted_total", "spec_accept_rate")},
            )
            self._ledger.flush(final=True)
            self._ledger = None
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
        drain: Dict[int, GenerationRequest] = {r.id: r for r in pending}
        for job in self._prefill:
            drain.setdefault(job.req.id, job.req)
        self._prefill.clear()
        for req in self._slot_req:
            if req is not None:
                drain.setdefault(req.id, req)
        for req in drain.values():
            if not req.done.is_set():
                req.error = "engine stopped"
                req.error_kind = "stopped"
                self._finalize_trace(req, "stopped")
                req.stream.put(None)
                req.done.set()
        # Spilled payloads of the requests just failed: nobody restores them.
        for handles in self._spilled.values():
            for handle in handles.values():
                self._host_tier.discard(handle)
        self._spilled.clear()

    def drain(self) -> None:
        """Stop admitting new requests; in-flight work runs to completion.
        ``stats()['state']`` becomes ``draining`` and :meth:`submit` raises
        :class:`EngineDrainingError`."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    def submit(self, prompt: List[int], max_new_tokens: int, temperature: float = 0.0,
               trace: Optional[TraceContext] = None) -> GenerationRequest:
        """Validate and enqueue; returns immediately with the request.

        ``trace`` opts the request into tracing (when ``trace_requests`` is
        on and the context is sampled): its phases are recorded as spans
        under the propagated trace id, parented to the caller's span, and the
        ended request carries its ``trace_summary``."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if any(t < 0 or t >= self.cfg.vocab_size for t in prompt):
            raise ValueError("token id out of vocabulary range")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be positive")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the engine's max_len ({self.max_len})"
            )
        needed = -(-(len(prompt) + max_new_tokens) // self.block_size)
        usable = self.block_allocator.num_blocks - 1
        if needed > usable:
            raise ValueError(
                f"request spans {needed} KV blocks but the pool only has "
                f"{usable}; raise num_blocks or shorten the request"
            )
        req = GenerationRequest(prompt, max_new_tokens, temperature)
        if trace is not None and self.trace_requests and trace.sampled:
            req.trace = _RequestTrace(trace, get_tracer().next_span_id())
        with self._cv:
            if self._stop.is_set():
                raise RuntimeError("engine is stopped")
            if self._draining:
                raise EngineDrainingError("engine is draining (no new admissions)")
            self._queue.append(req)
            self._n_submitted += 1
            self._cv.notify_all()
        return req

    def cancel(self, request_id: int) -> bool:
        """Best-effort immediate release of one request: a queued one fails in
        place, an in-flight one is failed by the scheduler on its next
        iteration (slot, blocks and prefix references released).  False for
        unknown or finished ids."""
        with self._cv:
            for req in list(self._queue):
                if req.id == request_id:
                    self._queue.remove(req)
                    with self._stats_lock:
                        self._n_cancelled += 1
                    req.error = "request cancelled"
                    req.error_kind = "cancelled"
                    self._finalize_trace(req, "cancelled")
                    req.stream.put(None)
                    req.done.set()
                    return True
            for req in self._slot_req:
                if req is not None and req.id == request_id and not req.done.is_set():
                    self._cancels.add(request_id)
                    self._cv.notify_all()
                    return True
        return False

    def generate(self, prompt: List[int], max_new_tokens: int, temperature: float = 0.0,
                 timeout: Optional[float] = None) -> List[int]:
        """Blocking convenience: submit and wait."""
        return self.submit(prompt, max_new_tokens, temperature).wait(timeout)

    def _utilization_snapshot(self) -> Dict[str, float]:
        """Busy fraction of wall time since start(), mean slot occupancy while
        busy, and their product."""
        with self._stats_lock:
            busy = self._busy_s
            occw = self._occ_weighted_s
        elapsed = time.time() - self._started_at if self._started_at else 0.0
        busy_frac = busy / elapsed if elapsed > 0 else 0.0
        occ = occw / busy if busy > 0 else 0.0
        return {
            "decode_busy_frac": round(busy_frac, 6),
            "slot_occupancy": round(occ, 6),
            "decode_utilization": round(busy_frac * occ, 6),
        }

    def _paging_snapshot(self) -> Dict[str, Any]:
        """Block-pool, prefix-cache and prefill-backlog state."""
        alloc = self.block_allocator
        total = alloc.num_blocks - 1
        pc = self.prefix_cache
        tier = self._host_tier
        with self._stats_lock:
            now = time.time()
            pc_rate_window = 0.0
            if pc is not None:
                self._pc_window.observe(pc.hits, pc.hits + pc.misses, now)
                windowed = self._pc_window.ratio(self._stats_window_s, now)
                # One sample: fall back to the lifetime ratio, not a false 0.
                pc_rate_window = round(windowed if windowed is not None else pc.hit_rate, 6)
            return {
                "block_size": self.block_size,
                "kv_dtype": self.kv_dtype,
                "kv_pool_bytes": self.kv_pool_bytes,
                "blocks_total": total,
                "blocks_free": alloc.n_free,
                "block_occupancy": round(alloc.n_used / total, 6) if total else 0.0,
                "prefix_cache_blocks": len(pc) if pc is not None else 0,
                "prefix_cache_hit_rate": round(pc.hit_rate, 6) if pc is not None else 0.0,
                "prefix_cache_hit_rate_window": pc_rate_window,
                "prefix_cache_hits": pc.hits if pc is not None else 0,
                "prefix_cache_misses": pc.misses if pc is not None else 0,
                "prefix_cache_evictions": pc.evictions if pc is not None else 0,
                "prefix_cache_demotions": pc.demotions if pc is not None else 0,
                "prefix_cache_restores": pc.demote_restores if pc is not None else 0,
                "parked_sequences": len(self._parked),
                "requests_shed": self._n_shed,
                "kv_offload": self.kv_offload,
                "host_tier_blocks": len(tier) if tier is not None else 0,
                "host_tier_bytes": tier.nbytes if tier is not None else 0,
                "host_spilled_blocks_total": self._n_spilled_blocks,
                "host_restored_blocks_total": self._n_restored_blocks,
                "kv_preloaded_blocks": self._kv_preloaded_blocks,
                "kv_persisted_blocks": self._kv_persisted_blocks,
                "prefill_backlog_chunks": self._backlog_chunks,
                "prefill_jobs": self._prefill_jobs,
                "block_parks": self._n_parks,
                "cow_copies": self._n_cow,
                "requests_cancelled": self._n_cancelled,
            }

    def _spec_snapshot(self) -> Dict[str, Any]:
        """Speculative-decoding acceptance state."""
        with self._stats_lock:
            proposed = self._spec_proposed
            accepted = self._spec_accepted
            now = time.time()
            self._spec_window.observe(accepted, proposed, now)
            windowed = self._spec_window.ratio(self._stats_window_s, now)
            fallbacks, steps = self._spec_fallbacks, self._spec_steps
        lifetime_rate = round(accepted / proposed, 6) if proposed else 0.0
        return {
            "spec_decode": self.spec_decode,
            "spec_k": self.spec_k,
            "spec_steps": steps,
            "spec_proposed_total": proposed,
            "spec_accepted_total": accepted,
            "spec_fallback_total": fallbacks,
            "spec_accept_rate": lifetime_rate,
            "spec_accept_rate_window": (
                round(windowed, 6) if windowed is not None else lifetime_rate
            ),
        }

    def _ledger_account(self, dt: float, occ_frac: float, tokens: int) -> None:
        """Fold one device-busy interval into the stats and the ledger."""
        with self._stats_lock:
            self._busy_s += dt
            self._occ_weighted_s += dt * occ_frac
        led = self._ledger
        if led is None:
            return
        led.account("step_compute_s", dt)
        if tokens:
            led.step(tokens=tokens)
        led.merge_extra(**self._utilization_snapshot())
        led.maybe_flush()

    def stats(self) -> Dict[str, Any]:
        util = self._utilization_snapshot()
        paging = self._paging_snapshot()
        spec = self._spec_snapshot()
        with self._stats_lock:
            now = time.time()
            while self._window and now - self._window[0][0] > 10.0:
                self._window.popleft()
            window_tokens = sum(n for _, n in self._window)
            window_span = now - self._window[0][0] if len(self._window) > 1 else 0.0
            tps = window_tokens / window_span if window_span > 0 else 0.0
            return {
                "state": (
                    "draining" if self._draining
                    else "ready" if self._ready.is_set() else "warming"
                ),
                "warmup": {
                    "done": self._warmup_done,
                    "total": self._warmup_total,
                    "ready_s": round(self._warmup_s, 6),
                },
                "steady_state_compiles": self._n_steady_compiles,
                "device": str(self.device),
                "slots": self.slots,
                "slots_active": self.allocator.n_active,
                # Per slot, the id of the request it holds (None when free):
                # what an HTTP client passes to /v1/cancel.
                "slot_request_ids": [r.id if r is not None else None for r in self._slot_req],
                "queue_depth": len(self._queue),
                "requests_submitted": self._n_submitted,
                "requests_finished": self._n_finished,
                "tokens_generated": self._n_tokens,
                "decode_steps": self._n_steps,
                "tokens_per_s": round(tps, 1),
                "max_len": self.max_len,
                "trace_exemplars": self._exemplars.snapshot(),
                **paging,
                **spec,
                **util,
            }

    def latency_summaries(self) -> Dict[str, Dict[str, float]]:
        """Histogram summaries (count/mean/p50/p95/p99) per latency key."""
        wanted = {
            "serving.queue_wait_s": "queue_wait_s",
            "serving.ttft_s": "ttft_s",
            "serving.decode_step_s": "decode_step_s",
            "serving.batch_occupancy": "batch_occupancy",
        }
        out: Dict[str, Dict[str, float]] = {}
        for key, summary in self.stats_registry.summaries().items():
            if key in wanted:
                out[wanted[key]] = {k: round(v, 6) for k, v in summary.items()}
        return out

    # -- persistent prefix store (warm replica boot) ---------------------------

    @staticmethod
    def _auto_persist_sig(params: Any, qweights: Any, seed: int) -> str:
        """Weight-identity fingerprint for an unsigned store: the seed, the
        weight-quantization flag, the trees' structure and the first and last
        16 elements of every leaf (a few small reads; it changes with the
        checkpoint, which geometry cannot).  ``""`` when the weights cannot be
        sampled."""
        try:
            h = hashlib.sha256()
            h.update(f"seed:{int(seed)};wq:{qweights is not None};".encode())
            for tree in (params, qweights):
                if tree is None:
                    continue
                leaves = _tree_leaves(tree)
                h.update(repr([path for path, _ in leaves]).encode())
                for _, leaf in leaves:
                    flat = leaf.detach().reshape(-1)
                    sample = torch.cat([flat[:16], flat[-16:]]).cpu().contiguous()
                    h.update(str(sample.dtype).replace("torch.", "").encode())
                    h.update(str(tuple(flat.shape)).encode())
                    h.update(sample.view(torch.uint8).numpy().tobytes())
            return "auto:" + h.hexdigest()[:16]
        except Exception:
            return ""

    def _kv_store_meta(self) -> Dict[str, Any]:
        """The fingerprint a snapshot must match exactly: the pool's geometry
        and storage dtype, and the model signature."""
        c = self.cfg
        return {
            "sig": self.kv_persist_sig,
            "kv_dtype": self.kv_dtype,
            "block_size": self.block_size,
            "n_layers": int(c.n_layers),
            "kv_heads": int(c.kv_heads),
            "head_dim": int(c.head_dim),
            "vocab_size": int(c.vocab_size),
        }

    def persist_prefixes(self) -> int:
        """Save the hottest prefix-cache blocks (chain-closed, see
        ``PrefixCache.hottest_chains``) to ``kv_persist_dir``; returns the
        blocks written.  Demoted entries persist straight from their host
        payloads.  Runs on whichever thread owns the pool (the scheduler, or
        any thread after it has stopped)."""
        pc = self.prefix_cache
        if not self.kv_persist_dir or pc is None:
            return 0
        entries = []
        for chain, block, handle in pc.hottest_chains(self.kv_persist_blocks):
            if block >= 0:
                [data] = self._export_blocks([block])
            elif handle is not None and self._host_tier is not None:
                data = self._host_tier.get(handle)
            else:
                continue
            entries.append((chain, data))
        if not entries:
            return 0
        version = kvstore.save_prefix_store(self.kv_persist_dir, entries,
                                            meta=self._kv_store_meta())
        if version is None:
            return 0
        self._last_persist_t = time.monotonic()
        self._last_persist_mut = pc.mutations
        with self._stats_lock:
            self._kv_persisted_blocks = len(entries)
        return len(entries)

    def _maybe_persist(self, force: bool = False) -> None:
        """A throttled snapshot: at most one per
        ``POLYAXON_TPU_KV_PERSIST_INTERVAL_S``, and only when the cache's
        entries changed (its mutation count, not its size) since the last.
        The scheduler calls it when idle: incumbents publish while running,
        since scale-up replicas boot when nobody is stopping."""
        pc = self.prefix_cache
        if not self.kv_persist_dir or pc is None or not len(pc):
            return
        if pc.mutations == self._last_persist_mut:
            return
        if not force and time.monotonic() - self._last_persist_t < self._kv_persist_interval_s:
            return
        try:
            self.persist_prefixes()
        except Exception:
            logger.exception("prefix store snapshot failed")

    def _preload_prefixes(self) -> None:
        """Warm boot: fill the prefix cache from the newest complete snapshot
        under ``kv_persist_dir`` (scheduler thread, before the ready gate),
        at most half the pool: a preload must not starve the first
        admissions."""
        pc = self.prefix_cache
        if not self.kv_persist_dir or pc is None:
            return
        loaded = kvstore.load_prefix_store(self.kv_persist_dir, expect=self._kv_store_meta())
        if not loaded:
            return
        budget = max(0, (self.block_allocator.num_blocks - 1) // 2)
        picked = []
        for chain, data in loaded[:budget]:
            block = self.block_allocator.alloc()
            if block is None:
                break
            picked.append((chain, block, data))
        # All copies are queued before any entry is installed: a copy that
        # fails leaves no entry that a prompt could match (the blocks go back
        # to the pool and the warmup boots cold).
        try:
            if picked:
                self._import_blocks([b for _, b, _ in picked], [d for _, _, d in picked])
        except BaseException:
            for _, block, _ in picked:
                self.block_allocator.decref(block)
            raise
        n = sum(pc.install(chain, block) for chain, block, _ in picked)
        with self._stats_lock:
            self._kv_preloaded_blocks = n
        # A freshly preloaded cache equals the stored one: do not write it back.
        self._last_persist_mut = pc.mutations
        self._last_persist_t = time.monotonic()

    # -- scheduler loop --------------------------------------------------------

    def _loop(self) -> None:
        tracer = get_tracer()
        self._run_warmup()
        while not self._stop.is_set():
            self._process_cancels()
            self._admit()
            progressed = self._resume_parked()
            # Prefill under a per-iteration token budget of one chunk: one
            # chunk of a long prompt, or several whole short prompts.  Jobs go
            # shortest-remaining-work first (min() is stable: ties stay FIFO),
            # so a short prompt overtakes a half-done long one.
            budget = self.prefill_chunk or 0
            spent = 0
            while self._prefill:
                job = min(self._prefill, key=lambda j: len(j.req.prompt) - j.next_pos)
                if job is not self._prefill[0]:
                    self._prefill.remove(job)
                    self._prefill.appendleft(job)
                remaining = len(job.req.prompt) - job.next_pos
                spent += min(remaining, budget) if budget else remaining
                try:
                    # One span a chunk, at the hot sample rate.
                    with tracer.span("serving.prefill", sample=tracer.hot_sample,
                                     request_id=job.req.id):
                        did = self._prefill_tick()
                except Exception as e:
                    logger.exception("prefill failed")
                    if self._prefill and self._prefill[0] is job:
                        self._prefill.popleft()
                    self._fail_slot(job.slot, f"prefill failed: {e!r}")
                    progressed = True
                    break
                if not did:
                    break  # blocked on the block pool; retry next iteration
                progressed = True
                if not budget or spent >= budget:
                    break
            if self._active.any():
                try:
                    with tracer.span("serving.step", sample=tracer.hot_sample):
                        self._step_once()
                except Exception as e:  # fail in-flight, keep serving
                    logger.exception("decode step failed")
                    for slot in np.nonzero(self._active)[0]:
                        self._fail_slot(int(slot), f"decode step failed: {e!r}")
                continue
            if progressed:
                continue
            if self._parked or self._prefill:
                # Nothing active, nothing moved, eviction already tried: the
                # requests waiting on blocks are deadlocked; shed one.
                self._resolve_block_deadlock()
                continue
            # Fully idle: a good moment for a (throttled) prefix-store
            # snapshot, which scale-up replicas preload.
            self._maybe_persist()
            with self._cv:
                if not self._queue and not self._stop.is_set():
                    self._cv.wait(timeout=0.2)

    def _admit(self) -> None:
        """Move queued requests into free slots (queue order) and enqueue
        their prefill jobs; the prefix cache shortens a job to its first
        uncached block."""
        while True:
            with self._cv:
                if not self._queue:
                    return
                slot = self.allocator.alloc()
                if slot is None:
                    return
                req = self._queue.popleft()
            req.started_at = time.time()
            self.stats_registry.timing("serving.queue_wait_s", req.started_at - req.submitted_at)
            self._trace_span(req, "serving.queue_wait", req.submitted_at,
                             req.started_at - req.submitted_at)
            self._trace_span(req, "serving.admit", req.started_at, 0.0, slot=slot)
            self._slot_req[slot] = req
            # Greedy requests get a drafter, seeded from the whole prompt (the
            # prefix cache may skip recomputing matched tokens, but the
            # drafter must see them); sampled ones ride single-token rows.
            if self.spec_decode:
                if req.temperature > 0:
                    with self._stats_lock:
                        self._spec_fallbacks += 1
                    self.stats_registry.incr("serving.spec_fallback_total", 1)
                else:
                    drafter = NgramDrafter(self.spec_min_ngram)
                    drafter.extend(req.prompt)
                    self._drafters[slot] = drafter
            job = _PrefillJob(req, slot)
            if self.prefix_cache is not None:
                try:  # a demoted prefix restores here
                    matched = self.prefix_cache.match(req.prompt)
                except Exception as e:
                    logger.exception("prefix restore failed")
                    self._fail_slot(slot, f"KV restore failed: {e!r}")
                    continue
                for i, block in enumerate(matched):
                    self._tables[slot, i] = block
                m = len(matched) * self.block_size
                if matched:
                    self._trace_span(req, "serving.prefix_cache.hit", time.time(), 0.0,
                                     blocks=len(matched), tokens=m)
                if m and m == len(req.prompt):
                    # Every prompt block hit.  The last token's logits must
                    # still be computed, and its KV row lands in the final
                    # shared block: copy it private first, then rerun it.
                    job.cow_pending = True
                    job.next_pos = m - 1
                else:
                    job.next_pos = m
            self._prefill.append(job)
            self._record_gauges()

    def _alloc_block(self) -> Optional[int]:
        """Allocate one pool block, evicting a cold cached prefix if the free
        list is empty."""
        block = self.block_allocator.alloc()
        if block is None and self.prefix_cache is not None:
            if self.prefix_cache.evict(1):
                block = self.block_allocator.alloc()
        return block

    def _prefill_tick(self) -> bool:
        """Run one chunk of the head prefill job.  True if the device did
        work; False when the job is blocked on the block pool (it stays at
        the head and retries next iteration)."""
        job = self._prefill[0]
        req, slot = job.req, job.slot
        bs = self.block_size
        t = len(req.prompt)
        t0 = time.perf_counter()
        if job.cow_pending:
            fresh = self._alloc_block()
            if fresh is None:
                return False
            bi = (t - 1) // bs
            shared = int(self._tables[slot, bi])
            self._pool = decode.copy_block(self._pool, shared, fresh)
            self.block_allocator.decref(shared)
            self._tables[slot, bi] = fresh
            job.cow_pending = False
            with self._stats_lock:
                self._n_cow += 1
        n = t - job.next_pos
        if self.prefill_chunk:
            n = min(n, self.prefill_chunk)
        # Lazy block faults for the chunk's span; partial allocations are kept
        # on exhaustion (the retry only fills what is still unset).
        for bi in range(job.next_pos // bs, (job.next_pos + n - 1) // bs + 1):
            if self._tables[slot, bi] < 0:
                fresh = self._alloc_block()
                if fresh is None:
                    return False
                self._tables[slot, bi] = fresh
        chunk = np.asarray(req.prompt[job.next_pos : job.next_pos + n], np.int64)
        logits = self._chunk(self._table_array()[slot], chunk, job.next_pos)
        job.next_pos += n
        if req.trace is not None:
            t1 = time.perf_counter()
            self._trace_span(req, "serving.prefill.chunk", time.time() - (t1 - t0), t1 - t0,
                             tokens=n, pos=job.next_pos)
        done = job.next_pos >= t
        # Chunk compute is device-busy time serving one request; only the
        # final chunk emits a token.
        self._ledger_account(time.perf_counter() - t0, 1.0 / self.slots, tokens=1 if done else 0)
        if done:
            self._prefill.popleft()
            self._finalize_prefill(job, logits)
        self._record_gauges()
        self._progress.beat(step=self._n_steps)
        return True

    def _finalize_prefill(self, job: _PrefillJob, logits: torch.Tensor) -> None:
        """Prompt fully inserted: publish its blocks, pick the first token
        from the last chunk's logits, activate the slot."""
        req, slot = job.req, job.slot
        t = len(req.prompt)
        if self.prefix_cache is not None:
            full = t // self.block_size
            self.prefix_cache.offer(req.prompt, [int(self._tables[slot, i]) for i in range(full)])
        first = self._pick_first(logits, req.temperature)
        # Time to first token: prefill made it, the client can read it.
        ttft = time.time() - req.submitted_at
        self.stats_registry.timing("serving.ttft_s", ttft)
        if req.trace is not None:
            req.trace.ttft_s = ttft
            self._trace_span(req, "serving.first_token", time.time(), 0.0, ttft_s=round(ttft, 6))
        self._emit(slot, req, first)
        if not req.done.is_set():
            self._tok[slot] = first
            self._pos[slot] = t
            self._temps[slot] = req.temperature
            self._active[slot] = True

    def _pick_first(self, logits: torch.Tensor, temperature: float) -> int:
        """The first generated token, from the prefill logits [vocab] (a host
        read), picked as every later token is."""
        with torch.inference_mode():
            return int(self._to_host(
                self._sample(logits[None], np.array([temperature], np.float32)))[0])

    def _park(self, slot: int) -> None:
        """Pool exhausted at a block boundary: deactivate the slot with its
        state intact until it can resume.  With the host tier armed, the
        slot's private blocks (refcount 1; shared prefix blocks cost it
        nothing) spill to the tier and free: parking releases capacity
        instead of sitting on it.  A spill that fails fails its request."""
        self._active[slot] = False
        self._parked.append(slot)
        req = self._slot_req[slot]
        if req is not None and req.trace is not None:
            req.trace.parked_at = time.time()
        with self._stats_lock:
            self._n_parks += 1
        if self._host_tier is not None:
            t0 = time.perf_counter()
            try:
                self._spill_slot(slot)
            except Exception as e:
                logger.exception("KV spill failed")
                self._fail_slot(slot, f"KV spill failed: {e!r}")
            self._copy_clock["spill"]["host_s"] += time.perf_counter() - t0

    def _spill_slot(self, slot: int) -> None:
        """Move a parked slot's private blocks to the host tier (pinned)."""
        alloc = self.block_allocator
        spill_bi = [bi for bi in range(self._table_width)
                    if self._tables[slot, bi] >= 0 and alloc.refcount(int(self._tables[slot, bi])) == 1]
        if not spill_bi:
            return
        payloads = self._export_blocks([int(self._tables[slot, bi]) for bi in spill_bi])
        handles = self._spilled.setdefault(slot, {})
        for bi, data in zip(spill_bi, payloads):
            handles[bi] = self._host_tier.put(data, pinned=True)
            alloc.decref(int(self._tables[slot, bi]))
            self._tables[slot, bi] = -1
        req = self._slot_req[slot]
        if req is not None:
            self._trace_span(req, "serving.spill", time.time(), 0.0, blocks=len(spill_bi))
        with self._stats_lock:
            self._n_spilled_blocks += len(spill_bi)

    def _restore_slot(self, slot: int) -> tuple:
        """Bring a parked slot's spilled blocks back into fresh blocks, all or
        nothing: restoring starts only once the pool (after demoting or
        evicting cold prefixes) covers the slot's whole remaining need, the
        faulted position block included.  A partial restore would hold
        blocks while still parked, and that hold-and-wait livelocks against
        a prefill holding the rest.  Returns ``(moved, complete)``."""
        handles = self._spilled.get(slot)
        if not handles:
            return False, True
        need = len(handles)
        bi_pos = int(self._pos[slot]) // self.block_size
        if self._tables[slot, bi_pos] < 0 and bi_pos not in handles:
            need += 1  # the faulted position block resumes alongside
        alloc = self.block_allocator
        if alloc.n_free < need and self.prefix_cache is not None:
            self.prefix_cache.evict(need - alloc.n_free)
        if alloc.n_free < need:
            return False, False
        order = sorted(handles)
        n_restore = len(order)
        t0 = time.perf_counter()
        fresh = []
        for bi in order:
            fresh.append(self._alloc_block())
            self._tables[slot, bi] = fresh[-1]  # held by the slot, even if the copy fails
        self._import_blocks(fresh, [self._host_tier.pop(handles.pop(bi)) for bi in order])
        self._spilled.pop(slot, None)
        dt = time.perf_counter() - t0
        self._copy_clock["restore"]["host_s"] += dt
        req = self._slot_req[slot]
        if req is not None:
            self._trace_span(req, "serving.restore", time.time() - dt, dt, blocks=n_restore)
        return True, True

    def _resume_parked(self) -> bool:
        """Give parked slots another shot at their faulted block, oldest
        first; spilled blocks restore before the fault retries.  A restore
        that fails fails its request."""
        progressed = False
        for slot in list(self._parked):
            try:
                moved, complete = self._restore_slot(slot)
            except Exception as e:
                logger.exception("KV restore failed")
                self._fail_slot(slot, f"KV restore failed: {e!r}")
                progressed = True
                continue
            if moved:
                progressed = True
            if not complete:
                continue
            bi = int(self._pos[slot]) // self.block_size
            if self._tables[slot, bi] < 0:
                fresh = self._alloc_block()
                if fresh is None:
                    continue
                self._tables[slot, bi] = fresh
            self._unpark(slot)
            self._active[slot] = True
            progressed = True
        return progressed

    def _unpark(self, slot: int) -> None:
        """The one place a slot leaves the parked list (resume, retire,
        fail), so the parked list and the spill map cannot drift apart: a
        payload still spilled is discarded (resume has drained its map
        already; retire and fail abandon theirs)."""
        if slot in self._parked:
            self._parked.remove(slot)
            req = self._slot_req[slot]
            rt = req.trace if req is not None else None
            if rt is not None and rt.parked_at is not None:
                parked_s = time.time() - rt.parked_at
                rt.park_s += parked_s
                rt.parked_at = None
                self._trace_span(req, "serving.park", time.time() - parked_s, parked_s)
        handles = self._spilled.pop(slot, None)
        if handles and self._host_tier is not None:
            for handle in handles.values():
                self._host_tier.discard(handle)

    def _resolve_block_deadlock(self) -> None:
        """Nobody active, nobody progressing, eviction exhausted: shed the
        newest parked request (it holds blocks, so shedding frees some; the
        newest has the least work invested), else the head prefill job."""
        msg = "KV block pool exhausted (request shed)"
        holding = [s for s in self._parked if bool((self._tables[s] >= 0).any())]
        if holding:
            self._fail_slot(holding[-1], msg, kind="shed")
        elif self._prefill:
            self._fail_slot(self._prefill.popleft().slot, msg, kind="shed")
        elif self._parked:
            self._fail_slot(self._parked[-1], msg, kind="shed")

    def _process_cancels(self) -> None:
        """Apply cancellations to in-flight requests (scheduler thread: it
        owns the tables and allocators)."""
        with self._cv:
            if not self._cancels:
                return
            ids, self._cancels = self._cancels, set()
        for rid in ids:
            for job in list(self._prefill):
                if job.req.id == rid:
                    self._prefill.remove(job)
            for slot, req in enumerate(self._slot_req):
                if req is not None and req.id == rid:
                    self._fail_slot(slot, "request cancelled", kind="cancelled")
                    with self._stats_lock:
                        self._n_cancelled += 1
        self._record_gauges()

    def _step_once(self) -> None:
        bs = self.block_size
        # Block-boundary faults: a slot whose next write crosses into an
        # unallocated block needs one now, or parks until the pool has one.
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            bi = int(self._pos[slot]) // bs
            if self._tables[slot, bi] < 0:
                fresh = self._alloc_block()
                if fresh is None:
                    self._park(slot)
                else:
                    self._tables[slot, bi] = fresh
        if not self._active.any():
            return
        drafts = self._collect_drafts() if self.spec_decode else {}
        participants = [self._slot_req[int(s)] for s in np.nonzero(self._active)[0]
                        if self._slot_req[int(s)] is not None
                        and self._slot_req[int(s)].trace is not None]
        t0 = time.perf_counter()
        n_live = int(self._active.sum())
        emitted = 0
        if drafts:
            emitted = self._verify_once(drafts)
        else:
            toks = self._to_host(self._decode())  # the loop's one device read
            for slot in np.nonzero(self._active)[0]:
                slot = int(slot)
                tok = int(toks[slot])
                self._pos[slot] += 1
                self._tok[slot] = tok
                self._emit(slot, self._slot_req[slot], tok)
                emitted += 1
        with self._stats_lock:
            self._n_steps += 1
            self._window.append((time.time(), emitted))
        # The step advances every live slot at least one token, so its wall
        # time is the per-token latency each of them saw.
        step_dt = time.perf_counter() - t0
        self.stats_registry.timing("serving.decode_step_s", step_dt)
        self.stats_registry.observe("serving.batch_occupancy", float(n_live))
        # Per-request step spans ride at the hot sample rate: the waterfall's
        # decode phase is an interval and never depends on them.
        for req in participants:
            self._trace_hot(req, "serving.decode.step", time.time() - step_dt, step_dt,
                            batch=n_live)
        self._ledger_account(step_dt, n_live / self.slots, tokens=emitted)
        self._record_gauges()
        if self._ready.is_set():
            self._capture.on_step(self._n_steps)
        self._progress.beat(step=self._n_steps)

    def _collect_drafts(self) -> Dict[int, List[int]]:
        """Each active greedy lane's proposal, clipped to the request's
        remaining budget and to the KV blocks the pool can cover (pool
        pressure shortens a draft instead of parking)."""
        drafts: Dict[int, List[int]] = {}
        bs = self.block_size
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            drafter = self._drafters[slot]
            if drafter is None:
                continue
            req = self._slot_req[slot]
            k = min(self.spec_k, req.max_new_tokens - len(req.tokens) - 1)
            if k < 1:
                continue
            prop = drafter.draft(k)
            # Block faults for the draft span (row j writes pos + j; the pos
            # block was faulted by the caller).
            pos = int(self._pos[slot])
            for j in range(1, len(prop) + 1):
                bi = (pos + j) // bs
                if self._tables[slot, bi] < 0:
                    fresh = self._alloc_block()
                    if fresh is None:
                        prop = prop[: j - 1]
                        break
                    self._tables[slot, bi] = fresh
            if prop:
                drafts[slot] = prop
                self._trace_hot(req, "serving.spec.draft", time.time(), 0.0, proposed=len(prop))
        return drafts

    def _verify_once(self, drafts: Dict[int, List[int]]) -> int:
        """One draft → verify → rollback iteration; returns tokens emitted."""
        width = self._width_for(max(len(p) for p in drafts.values()))
        tok_in = np.zeros((self.slots, width), np.int64)
        tok_in[:, 0] = self._tok
        n_tok = np.ones(self.slots, np.int64)
        for slot, prop in drafts.items():
            tok_in[slot, 1 : 1 + len(prop)] = prop
            n_tok[slot] = 1 + len(prop)
        res = self._verify(tok_in, n_tok)
        out, n_emit = res[:, :-1], res[:, -1]
        emitted = n_proposed = n_accepted = 0
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            req = self._slot_req[slot]
            e = int(n_emit[slot])
            prop = drafts.get(slot)
            if prop is not None:
                n_proposed += len(prop)
                n_accepted += e - 1
                self.stats_registry.observe("serving.spec_accept_len", float(e - 1))
                self._trace_hot(req, "serving.spec.verify", time.time(), 0.0,
                                proposed=len(prop), accepted=e - 1)
            self._pos[slot] += e
            self._tok[slot] = int(out[slot, e - 1])
            # Rollback: blocks wholly past the next write position go back.
            truncate_table(self._tables[slot], self.block_allocator,
                           int(self._pos[slot]), self.block_size)
            for j in range(e):
                self._emit(slot, req, int(out[slot, j]))
                emitted += 1
                if req.done.is_set():
                    break  # eos or budget retired the slot mid-run
        with self._stats_lock:
            self._spec_steps += 1
            self._spec_proposed += n_proposed
            self._spec_accepted += n_accepted
        if n_proposed:
            self.stats_registry.incr("serving.spec_proposed_total", n_proposed)
        if n_accepted:
            self.stats_registry.incr("serving.spec_accepted_total", n_accepted)
        return emitted

    def _record_gauges(self) -> None:
        """Refresh the paging gauges and backlog counters (scheduler thread)."""
        self._check_steady_compiles()
        backlog = 0
        for job in self._prefill:
            remaining = len(job.req.prompt) - job.next_pos
            step = self.prefill_chunk or max(remaining, 1)
            backlog += max(1, -(-remaining // step))
        with self._stats_lock:
            self._backlog_chunks = backlog
            self._prefill_jobs = len(self._prefill)
        gauge = self.stats_registry.gauge
        alloc = self.block_allocator
        total = alloc.num_blocks - 1
        gauge("serving.block_occupancy", round(alloc.n_used / total, 6) if total else 0.0)
        gauge("serving.blocks_free", float(alloc.n_free))
        gauge("serving.kv_pool_bytes", float(self.kv_pool_bytes))
        pc = self.prefix_cache
        gauge("serving.prefix_cache_hit_rate", round(pc.hit_rate, 6) if pc is not None else 0.0)
        gauge("serving.prefill_backlog_chunks", float(backlog))
        gauge("serving.parked_sequences", float(len(self._parked)))
        if pc is not None:
            gauge("serving.prefix_cache_evictions", float(pc.evictions))
            gauge("serving.prefix_cache_demotions", float(pc.demotions))
            gauge("serving.prefix_cache_restores", float(pc.demote_restores))
        if self._host_tier is not None:
            gauge("serving.host_tier_blocks", float(len(self._host_tier)))
            gauge("serving.host_tier_bytes", float(self._host_tier.nbytes))
        if self.spec_decode:
            with self._stats_lock:
                proposed, accepted = self._spec_proposed, self._spec_accepted
            gauge("serving.spec_accept_rate", round(accepted / proposed, 6) if proposed else 0.0)

    # -- request tracing -------------------------------------------------------

    def _trace_span(self, req: GenerationRequest, name: str, start: float, duration: float,
                    **attrs: Any) -> None:
        """Record one phase span under the request's trace (no-op for an
        untraced request)."""
        rt = req.trace
        if rt is None:
            return
        get_tracer().record_span(name, start=start, duration=duration,
                                 trace_id=rt.ctx.trace_id, parent_id=rt.root_id,
                                 request_id=req.id, **attrs)

    def _trace_hot(self, req: GenerationRequest, name: str, start: float, duration: float,
                   **attrs: Any) -> None:
        """A hot-path phase span (a decode step, a draft, a verify), kept at
        the tracer's hot sample rate."""
        if req.trace is None:
            return
        rate = get_tracer().hot_sample
        if rate < 1.0 and (rate <= 0.0 or random.random() >= rate):
            return
        self._trace_span(req, name, start, duration, **attrs)

    def _finalize_trace(self, req: GenerationRequest, outcome: str) -> None:
        """Close the request's trace: its root span, its latency waterfall,
        and an offer to the slow-request exemplars.  Runs on every terminal
        path (finished, shed, cancelled, stopped, failed), so a traced
        request never leaves a span open."""
        rt = req.trace
        if rt is None or req.trace_summary is not None:
            return
        now = req.finished_at if req.finished_at is not None else time.time()
        req.finished_at = now
        if rt.parked_at is not None:  # ended while parked
            rt.park_s += now - rt.parked_at
            rt.parked_at = None
        total = max(0.0, now - req.submitted_at)
        started, first = req.started_at, req.first_token_at
        waterfall: Dict[str, float] = {
            "queue_wait_s": max(0.0, (started if started is not None else now) - req.submitted_at),
        }
        if started is not None:
            waterfall["prefill_s"] = max(0.0, (first if first is not None else now) - started)
        if first is not None:
            waterfall["decode_s"] = max(0.0, now - first - rt.park_s)
        if rt.park_s > 0:
            waterfall["parked_s"] = rt.park_s
        # The root span: every phase span parents to it, and it parents to
        # the caller's span (a router attempt or the lm_server handler).
        get_tracer().record_span(
            "serving.request", start=req.submitted_at, duration=total,
            trace_id=rt.ctx.trace_id, span_id=rt.root_id, parent_id=rt.ctx.span_id or None,
            request_id=req.id, outcome=outcome, tokens=len(req.tokens),
        )
        self._trace_span(req, "serving.finish", now, 0.0, outcome=outcome)
        req.trace_summary = {
            "trace_id": rt.ctx.trace_id,
            "span_id": rt.root_id,
            "request_id": req.id,
            "outcome": outcome,
            "total_s": round(total, 6),
            "ttft_s": round(rt.ttft_s, 6) if rt.ttft_s is not None else None,
            "tokens": len(req.tokens),
            "finished_at": now,
            "waterfall": {k: round(v, 6) for k, v in waterfall.items()},
        }
        self._exemplars.offer(req.trace_summary)

    def _emit(self, slot: int, req: GenerationRequest, tok: int) -> None:
        """Record one generated token; retire the slot when done."""
        if req.first_token_at is None:
            req.first_token_at = time.time()
        drafter = self._drafters[slot]
        if drafter is not None:
            drafter.append(tok)  # accepted tokens extend the suffix index
        req.tokens.append(tok)
        req.stream.put(tok)
        with self._stats_lock:
            self._n_tokens += 1
        hit_eos = self.eos_id is not None and tok == self.eos_id
        if len(req.tokens) >= req.max_new_tokens or hit_eos:
            self._retire(slot, req)

    def _release_slot_blocks(self, slot: int) -> None:
        """Drop the slot's reference on every block in its table; blocks a
        neighbour or the prefix cache still holds stay allocated."""
        for bi in range(self._table_width):
            block = int(self._tables[slot, bi])
            if block >= 0:
                self.block_allocator.decref(block)
        self._tables[slot, :] = -1

    def _free_slot(self, slot: int) -> None:
        self._active[slot] = False
        self._unpark(slot)
        self._release_slot_blocks(slot)
        self._slot_req[slot] = None
        self._drafters[slot] = None
        self.allocator.free(slot)

    def _retire(self, slot: int, req: GenerationRequest) -> None:
        req.finished_at = time.time()
        self._free_slot(slot)
        self._finalize_trace(req, "completed")
        req.stream.put(None)
        req.done.set()
        with self._stats_lock:
            self._n_finished += 1
        # Waiters take freed slots on the next admit: immediately.
        with self._cv:
            self._cv.notify_all()

    def _fail_slot(self, slot: int, msg: str, kind: Optional[str] = None) -> None:
        req = self._slot_req[slot]
        self._free_slot(slot)
        if kind == "shed":
            with self._stats_lock:
                self._n_shed += 1
        if req is not None and not req.done.is_set():
            req.error = msg
            req.error_kind = kind
            req.finished_at = time.time()
            self._finalize_trace(req, kind or "error")
            req.stream.put(None)
            req.done.set()
