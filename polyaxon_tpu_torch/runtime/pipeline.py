"""The overlapped training input pipeline and off-loop metric reads.

The port's copy of ``polyaxon_tpu/runtime/pipeline.py``:

- :class:`HostPrefetcher`, a bounded-queue background prefetcher that
  gathers batch *i+1*'s rows on worker threads while step *i* runs, in the
  source's exact (resumable) order;
- :func:`device_prefetch`, which places the next batches before the
  current one is consumed.  Given a card, it stages each host batch in
  pinned buffers and copies it on a copy stream of its own; the consumer's
  stream waits on the copy's event before it touches the batch, and a
  pinned buffer is refilled only after its previous copy's event;
- :class:`TrainPipeline`, the two behind one iterator, with ``prefetch=0``
  the synchronous path (a byte-identical stream);
- :class:`MetricsDrain`, which reads per-step device metrics on a thread of
  its own, so logging never puts a device sync in the loop.

Host gathers are numpy and threads; placement runs on the consumer's
thread.  :attr:`TrainPipeline.data_wait_s` and
:meth:`TrainPipeline.pop_data_wait_s` are what a trainer folds into the
utilization ledger's ``data_wait_s`` bucket.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from polyaxon_tpu_torch.tracking.trace import get_tracer


class _Done:
    """Queue sentinel: source exhausted (or raised — carries the error)."""

    def __init__(self, error: Optional[BaseException] = None) -> None:
        self.error = error


class HostPrefetcher:
    """Bounded-queue background prefetcher preserving stream order.

    ``source`` yields zero-arg *tasks* (``tasks=True``, e.g.
    :meth:`DatasetReader.batch_tasks`) or plain items.  A dispatcher thread
    walks the source strictly in order, submits each task to a worker pool,
    and enqueues the resulting future into a bounded queue; the consumer
    pops futures in submission order, so the delivered stream is exactly
    the source's order however many workers gather concurrently.

    Backpressure: the queue holds at most ``depth`` futures, so the
    dispatcher runs at most ``depth + 1`` items ahead of the consumer.

    A task that raises delivers its exception at its position in the
    stream (the consumer's ``next()`` raises); ``close()`` always unblocks
    and joins the dispatcher, so a crashing trainer can't leak threads.
    """

    def __init__(
        self,
        source: Iterable[Any],
        *,
        depth: int = 2,
        workers: int = 1,
        tasks: bool = True,
    ) -> None:
        self._source = iter(source)
        self._tasks = tasks
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = False
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers), thread_name_prefix="prefetch")
        #: Cumulative seconds the consumer spent blocked waiting for data.
        self.wait_s = 0.0
        self._dispatcher = threading.Thread(
            target=self._dispatch, name="prefetch-dispatch", daemon=True
        )
        self._dispatcher.start()

    # -- producer side --------------------------------------------------------
    def _put(self, item: Any) -> bool:
        """Enqueue, but never deadlock against a vanished consumer."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _dispatch(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                if self._tasks:
                    fut = self._pool.submit(self._traced(item))
                else:
                    fut = Future()
                    fut.set_result(item)
                if not self._put(fut):
                    fut.cancel()
                    return
            self._put(_Done())
        except BaseException as exc:  # the source itself raised mid-iteration
            self._put(_Done(error=exc))

    @staticmethod
    def _traced(task: Callable[[], Any]) -> Callable[[], Any]:
        """Wrap a gather task in a (hot-rate-sampled) tracer span."""
        tracer = get_tracer()

        def run() -> Any:
            with tracer.span("pipeline.gather", sample=tracer.hot_sample):
                return task()

        return run

    # -- consumer side --------------------------------------------------------
    def __iter__(self) -> "HostPrefetcher":
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        got = self._q.get()
        if isinstance(got, _Done):
            self._done = True
            self.wait_s += time.perf_counter() - t0
            if got.error is not None:
                raise got.error
            raise StopIteration
        out = got.result()  # blocks until the worker finishes; re-raises
        self.wait_s += time.perf_counter() - t0
        return out

    def close(self) -> None:
        """Stop the dispatcher and workers; idempotent, exception-safe."""
        self._stop.set()
        # Drain so a dispatcher blocked in put() can observe the stop flag.
        while self._dispatcher.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._dispatcher.join(timeout=0.05)
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self) -> "HostPrefetcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _host_array(value: Any) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _tree_map(fn: Callable[[Any], Any], item: Any) -> Any:
    """``fn`` over the leaves of a dict / list / tuple batch."""
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_tree_map(fn, v) for v in item)
    return fn(item)


def to_device(device: Any) -> Callable[[Any], Any]:
    """A ``place`` that copies a host batch's arrays to ``device`` (a
    synchronous copy: the ``prefetch=0`` path and the CPU's)."""
    dev = torch.device(device)

    def place(item: Any) -> Any:
        return _tree_map(lambda a: torch.as_tensor(_host_array(a)).to(dev), item)

    return place


class _CudaStager:
    """Host batches onto a card through pinned buffers and a copy stream.

    :meth:`put` copies a batch's arrays into a ring slot of pinned buffers,
    queues their host-to-device copies on the copy stream (the device
    tensors allocated there) and records an event; :meth:`take` makes the
    consumer's current stream wait on that event and marks the tensors as
    used on it, so the allocator does not hand their memory to the copy
    stream while the consumer reads them.  A slot is refilled only after
    the event of its previous copy: a pinned buffer is never overwritten
    while the card still reads it.
    """

    def __init__(self, device: torch.device, slots: int) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._pinned: List[Dict[Any, torch.Tensor]] = [{} for _ in range(max(1, slots))]
        self._events: List[Optional[torch.cuda.Event]] = [None] * max(1, slots)
        self._n = 0

    def put(self, item: Any) -> Any:
        slot = self._n % len(self._pinned)
        self._n += 1
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        pinned = self._pinned[slot]
        leaves = itertools.count()

        def stage(value: Any) -> torch.Tensor:
            arr = np.ascontiguousarray(_host_array(value))
            key = next(leaves)
            buf = pinned.get(key)
            src = torch.from_numpy(arr)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = pinned[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
            return buf.to(self.device, non_blocking=True)

        with torch.cuda.stream(self.stream):
            placed = _tree_map(stage, item)
            event = torch.cuda.Event()
            event.record(self.stream)
        self._events[slot] = event
        return placed, event

    def take(self, staged: Any) -> Any:
        placed, event = staged
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)

        def mark(t: torch.Tensor) -> torch.Tensor:
            t.record_stream(current)
            return t

        return _tree_map(mark, placed)


def device_prefetch(
    host_iter: Iterable[Any],
    place: Any,
    depth: int = 1,
) -> Iterator[Any]:
    """Keep ``depth`` placed batches in flight ahead of the consumer.

    ``place`` is a callable (run on batch *i+1* before batch *i* is
    yielded, on the consumer's thread) or a device.  On a card, each batch
    is staged in pinned buffers and copied on a copy stream
    (:class:`_CudaStager`): the copy of batch *i+1* runs while step *i*
    computes, and batch *i* is handed over with the consumer's stream
    waiting on its copy.  On the CPU the batch's arrays become tensors.
    """
    if callable(place):
        put, take = place, (lambda x: x)
    else:
        dev = torch.device(place)
        if dev.type == "cuda":
            stager = _CudaStager(dev, slots=max(0, depth) + 2)
            put, take = stager.put, stager.take
        else:
            put, take = to_device(dev), (lambda x: x)
    buf: deque = deque()
    for item in host_iter:
        buf.append(put(item))
        if len(buf) > depth:
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())


class TrainPipeline:
    """Host prefetch → device prefetch behind one iterator.

    ``place`` is a callable, a device (the batches' arrays go there:
    through pinned buffers and a copy stream on a card), or None (items as
    they come).  ``prefetch`` is the host-side queue depth (0 disables all
    overlap: tasks run inline on the consumer thread, placement is
    synchronous — the stream stays byte-identical either way).  ``workers``
    is the gather thread count.  ``data_wait_s`` accumulates the seconds the
    hot loop spent blocked inside ``next()`` — the number that should go to
    ~0 when overlap is winning.
    """

    def __init__(
        self,
        source: Iterable[Any],
        place: Any = None,
        *,
        prefetch: int = 2,
        workers: int = 2,
        tasks: bool = True,
        device_depth: int = 1,
    ) -> None:
        if place is None:
            self.place: Callable[[Any], Any] = lambda x: x
        elif callable(place):
            self.place = place
        else:
            self.place = to_device(place)
        self.data_wait_s = 0.0
        self._last_wait_mark = 0.0
        self._prefetcher: Optional[HostPrefetcher] = None
        if prefetch > 0:
            self._prefetcher = HostPrefetcher(source, depth=prefetch, workers=workers, tasks=tasks)
            self._it = device_prefetch(
                self._prefetcher, place if place is not None else self.place,
                depth=max(0, device_depth),
            )
        else:
            self._it = self._sync_iter(source, tasks)

    def _sync_iter(self, source: Iterable[Any], tasks: bool) -> Iterator[Any]:
        for item in source:
            yield self.place(item() if tasks else item)

    def __iter__(self) -> "TrainPipeline":
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        batch = next(self._it)
        self.data_wait_s += time.perf_counter() - t0
        return batch

    def pop_data_wait_s(self) -> float:
        """Seconds blocked on data since the previous call (per-interval)."""
        now, last = self.data_wait_s, self._last_wait_mark
        self._last_wait_mark = now
        return now - last

    def close(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()
        if hasattr(self._it, "close"):
            self._it.close()

    def __enter__(self) -> "TrainPipeline":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class MetricsDrain:
    """Fetch per-step device metrics off the hot loop.

    ``push(step, {name: tensor})`` returns at once; a daemon thread reads
    the values and hands ``{name: float}`` to ``emit`` in push order, so the
    loop never pays a device sync just to log.  On the card ``push`` starts
    a non-blocking copy of each scalar into pinned host memory and records
    an event; the drain thread waits on the event, never the loop thread.

    The queue is bounded (a queued value pins its buffer): if the host falls
    ``depth`` fetches behind, ``push`` blocks.  ``close()`` drains everything
    still queued, so no pushed metric is lost; an ``emit`` or fetch error is
    re-raised there.  :attr:`close_wait_s` is the seconds ``close()`` spent
    draining the backlog.
    """

    _DONE = object()

    def __init__(
        self,
        emit: Callable[[Optional[int], Dict[str, float]], None],
        *,
        depth: int = 8,
    ) -> None:
        self._emit = emit
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._error: Optional[BaseException] = None
        #: Last drained values / step (host floats), for end-of-run logs.
        self.last: Dict[str, float] = {}
        self.last_step: Optional[int] = None
        self.close_wait_s = 0.0
        self._thread = threading.Thread(target=self._run, name="metrics-drain", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            got = self._q.get()
            if got is self._DONE:
                return
            step, values, ready = got
            try:
                if ready is not None:
                    ready.synchronize()
                host = {k: float(v) for k, v in values.items()}
                self._emit(step, host)
                self.last, self.last_step = host, step
            except Exception as exc:  # surfaced by close()
                if self._error is None:
                    self._error = exc

    def push(self, step: Optional[int], values: Dict[str, Any]) -> None:
        ready = None
        if any(isinstance(v, torch.Tensor) and v.is_cuda for v in values.values()):
            staged = {}
            for k, v in values.items():
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    host.copy_(v.detach(), non_blocking=True)
                    v = host
                staged[k] = v
            ready = torch.cuda.Event()
            ready.record()
            values = staged
        self._q.put((step, values, ready))

    def close(self) -> None:
        """Drain everything queued, join the thread, surface any error."""
        t0 = time.perf_counter()
        try:
            self._q.put(self._DONE)
            self._thread.join()
        finally:
            self.close_wait_s += time.perf_counter() - t0
        if self._error is not None:
            raise self._error
