"""Per-run goodput and utilization ledger.

The port's copy of ``polyaxon_tpu/tracking/ledger.py``.
:class:`UtilizationLedger` decomposes a run's wall clock into named buckets
(compile, data wait, step compute, checkpoint block, metric drain, idle),
counts model FLOPs per step, and keeps the card's memory high-water mark.
Rows go out as typed ``ledger`` report lines (the reporter is the sink), in
the reference's format, so the control plane's watcher, registry and
``goodput_status`` take them as they take a JAX worker's.

What differs from the reference, and why:

- **The peak.** :data:`PEAK_FLOPS` keeps the reference's entries, keyed by a
  device's kind, and adds the H100's dense bf16 peak under its
  ``torch.cuda.get_device_name()``.  :meth:`UtilizationLedger.start` takes
  the workload's device: a card gives ``devices`` 1 and its name (the port
  runs one rank a card), the CPU 0 and ``""``.  A card missing from the
  table gets no peak, and MFU 0.0.
- **Compile telemetry.** The ``xla_compile_s`` bucket keeps its name, since
  the registry reads that vocabulary; its events are the port's own, which
  :func:`record_compile` counts: a kernel build (``_build.py``, one ``nvcc``
  a source: compile seconds, events and cache misses), the load of a kernel
  library already built (a cache hit) and a CUDA graph capture
  (``models/decode.py:capture_step``: compile seconds and an event).
- **FLOPs are analytic.**  The reference's ``executable_flops`` and
  ``compiled_flops`` read XLA's cost analysis of a compiled executable; an
  eager PyTorch step has no such analysis, so they have no counterpart and
  workloads pass :func:`transformer_flops_per_token` and its kin.

Process-wide singleton, as ``trace.get_tracer()``: workloads call
:func:`get_ledger` and feed it; whoever owns the report channel calls
:func:`configure` to give it a sink.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from polyaxon_tpu_torch.conf.knobs import knob_float

__all__ = [
    "UtilizationLedger",
    "get_ledger",
    "configure",
    "record_compile",
    "compile_telemetry",
    "compile_cache_telemetry",
    "transformer_flops_per_token",
    "conv_classifier_flops_per_image",
    "BUCKETS",
    "PEAK_FLOPS",
]

#: The wall-clock decomposition vocabulary.  Every row's ``buckets`` has
#: exactly these keys, and they sum to the row's ``wall_s`` (``idle_s`` is
#: the remainder, clamped at 0).
BUCKETS = (
    "xla_compile_s",
    "data_wait_s",
    "step_compute_s",
    "ckpt_block_s",
    "metric_drain_s",
    "idle_s",
)

#: Dense bf16 peak FLOP/s per device, by kind (a TPU's PJRT device kind, a
#: card's ``torch.cuda.get_device_name()``).  Absent kinds resolve to no
#: peak, so MFU reads 0.0 rather than a made-up ratio.
PEAK_FLOPS = {
    "TPU v4": 275e12,
    "TPU v5 lite": 197e12,
    "TPU v5e": 197e12,
    "TPU v5": 459e12,
    "TPU v5p": 459e12,
    "TPU v6 lite": 918e12,
    "TPU v6e": 918e12,
    "NVIDIA H100 80GB HBM3": 989e12,
}

_UNSET = object()


# -- compile telemetry ----------------------------------------------------------

_compile_lock = threading.Lock()
_compile_seconds = 0.0
_compile_events = 0
_cache_hits = 0
_cache_misses = 0


def record_compile(seconds: float = 0.0, *, events: int = 0, hits: int = 0,
                   misses: int = 0) -> None:
    """Count compile work: ``seconds`` of wall spent compiling (kernel builds,
    graph captures), ``events`` compiles, and kernel-cache ``hits`` (a
    library already built was loaded) and ``misses`` (a library was built)."""
    global _compile_seconds, _compile_events, _cache_hits, _cache_misses
    with _compile_lock:
        _compile_seconds += float(seconds)
        _compile_events += int(events)
        _cache_hits += int(hits)
        _cache_misses += int(misses)


def compile_telemetry() -> Tuple[float, int]:
    """(cumulative compile seconds, cumulative compile events) so far."""
    with _compile_lock:
        return _compile_seconds, _compile_events


def compile_cache_telemetry() -> Tuple[int, int]:
    """(kernel-cache hits, misses) so far."""
    with _compile_lock:
        return _cache_hits, _cache_misses


# -- FLOPs accounting -------------------------------------------------------------

def transformer_flops_per_token(
    n_params: int, n_layers: int, n_heads: int, head_dim: int, seq: int
) -> float:
    """Train-step FLOPs per token: 6·N (fwd+bwd matmuls) + attention
    scores 12·L·H·hd·T (fwd+bwd, causal halves then doubles back) — the
    same accounting ``bench.py`` uses for its headline MFU."""
    return 6.0 * n_params + 12.0 * n_layers * n_heads * head_dim * seq


def conv_classifier_flops_per_image(
    image_size: int,
    in_channels: int,
    channels: Tuple[int, ...],
    dense_dim: int,
    n_classes: int,
) -> float:
    """Analytic train-step FLOPs per image for the builtin conv net
    (3x3 SAME convs + 2x2 maxpool per stage + dense head): 2 FLOPs per
    MAC forward, x3 for forward+backward."""
    flops = 0.0
    h = image_size
    cin = in_channels
    for cout in channels:
        flops += 2.0 * h * h * 9.0 * cin * cout
        h //= 2
        cin = cout
    flat = h * h * cin
    flops += 2.0 * flat * dense_dim + 2.0 * dense_dim * n_classes
    return 3.0 * flops


# -- the accountant ---------------------------------------------------------------

class UtilizationLedger:
    """Wall-clock decomposition and live MFU accountant for one workload.

    Feeding is cheap (a lock and float adds): trainers call :meth:`step` /
    :meth:`account` each step and :meth:`maybe_flush` to emit a cumulative
    row at most every ``interval_s``; a final row with ``final=True`` goes
    out at the workload's end.  Rows are cumulative and ``seq``-numbered, so
    consumers take the latest row of each process.
    """

    def __init__(
        self,
        *,
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
        process_id: int = 0,
        interval_s: Optional[float] = None,
    ) -> None:
        self.sink = sink
        self.process_id = process_id
        if interval_s is None:
            interval_s = knob_float("POLYAXON_TPU_LEDGER_INTERVAL_S")
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._reset_locked()

    def _reset_locked(self) -> None:
        self.armed = False
        self.source = "train"
        self._t0_wall = 0.0
        self._p0 = 0.0
        self._acc: Dict[str, float] = {}
        self._step_wall_s = 0.0
        self.steps = 0
        self.tokens = 0
        self.flops = 0.0
        self._flops_per_step: Optional[float] = None
        self.devices = 0
        self.device_kind = ""
        self.peak_flops_per_s = 0.0
        self._device: Optional[torch.device] = None
        self._hbm_peak_bytes = 0.0
        self._extra: Dict[str, Any] = {}
        self._seq = 0
        self._last_flush = 0.0
        self._compile0: Tuple[float, int] = (0.0, 0)
        self._cache0: Tuple[int, int] = (0, 0)
        self._compile_preloop: Optional[float] = None

    def reset(self) -> None:
        with self._lock:
            self._reset_locked()

    def configure(
        self,
        *,
        sink: Any = _UNSET,
        process_id: Any = _UNSET,
        interval_s: Any = _UNSET,
    ) -> "UtilizationLedger":
        """In-place update: workloads holding a :func:`get_ledger` reference
        see the new sink."""
        with self._lock:
            if sink is not _UNSET:
                self.sink = sink
            if process_id is not _UNSET:
                self.process_id = process_id
            if interval_s is not _UNSET:
                self.interval_s = interval_s
        return self

    # -- arming ----------------------------------------------------------------

    def start(self, *, source: str = "train", device: Any = None) -> "UtilizationLedger":
        """Arm at workload entry: reset the totals, take the compile counters
        as the baseline (back-to-back workloads in one process do not
        inherit each other's compile time), and read the peak of ``device``,
        the card the workload runs on (None or the CPU: no device, no peak)."""
        dev = torch.device(device) if device is not None else None
        with self._lock:
            sink, process_id, interval = self.sink, self.process_id, self.interval_s
            self._reset_locked()
            self.sink, self.process_id, self.interval_s = sink, process_id, interval
            self.armed = True
            self.source = source
            self._t0_wall = time.time()
            self._p0 = time.perf_counter()
            self._last_flush = self._p0
            self._compile0 = compile_telemetry()
            self._cache0 = compile_cache_telemetry()
        if dev is not None and dev.type == "cuda":
            kind = torch.cuda.get_device_name(dev)
            with self._lock:
                self._device = dev
                self.devices = 1
                self.device_kind = kind
                self.peak_flops_per_s = PEAK_FLOPS.get(kind, 0.0)
        return self

    # -- feeding ---------------------------------------------------------------

    def set_flops_per_step(self, flops: Optional[float]) -> None:
        with self._lock:
            self._flops_per_step = float(flops) if flops else None

    def mark_loop_start(self) -> None:
        """Compile work from here on happened inside the hot loop, and so
        inside measured step wall (a kernel built by the first step, a graph
        captured in the loop): the snapshot subtracts it from step compute.
        Without this call the first :meth:`step` marks it, which files the
        first step's own compile as step compute; call it right before the
        loop."""
        compile_s, _ = compile_telemetry()
        with self._lock:
            if self._compile_preloop is None:
                self._compile_preloop = compile_s - self._compile0[0]

    def merge_extra(self, **extra: Any) -> None:
        """Workload-specific fields for the row's ``extra`` (the serving
        engine's occupancy, cache and pool figures)."""
        with self._lock:
            self._extra.update(extra)

    def account(self, bucket: str, seconds: float) -> None:
        """Fold externally measured seconds into a named bucket."""
        if seconds and seconds > 0:
            with self._lock:
                self._acc[bucket] = self._acc.get(bucket, 0.0) + float(seconds)

    def step(
        self,
        dt: Optional[float] = None,
        *,
        tokens: int = 0,
        flops: Optional[float] = None,
    ) -> None:
        """One training or decode step: ``dt`` is its wall seconds (omit it
        when the workload accounts ``step_compute_s`` itself), ``tokens`` the
        tokens or examples it advanced."""
        compile_s, _ = compile_telemetry()
        with self._lock:
            if self._compile_preloop is None:
                self._compile_preloop = compile_s - self._compile0[0]
            self.steps += 1
            self.tokens += int(tokens)
            if dt is not None and dt > 0:
                self._step_wall_s += float(dt)
            if flops is not None:
                self.flops += float(flops)
            elif self._flops_per_step is not None:
                self.flops += self._flops_per_step

    def sample_hbm(self) -> float:
        """Refresh the memory high-water mark from the card's caching
        allocator (``allocated_bytes.all.peak``); 0 on the CPU."""
        total = 0.0
        dev = self._device
        if dev is not None and torch.cuda.is_initialized():
            try:
                total = float(torch.cuda.memory_stats(dev).get("allocated_bytes.all.peak", 0))
            except Exception:
                pass
        with self._lock:
            if total > self._hbm_peak_bytes:
                self._hbm_peak_bytes = total
            return self._hbm_peak_bytes

    # -- reading / emitting ----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Cumulative totals as one row: the bucket decomposition (summing
        to ``wall_s``), goodput, MFU, throughput, compile and memory
        telemetry."""
        compile_now, events_now = compile_telemetry()
        hits_now, misses_now = compile_cache_telemetry()
        with self._lock:
            wall = time.perf_counter() - self._p0 if self.armed else 0.0
            hooks_compile = max(0.0, compile_now - self._compile0[0])
            compile_s = hooks_compile + self._acc.get("xla_compile_s", 0.0)
            compile_events = max(0, events_now - self._compile0[1])
            data = self._acc.get("data_wait_s", 0.0)
            ckpt = self._acc.get("ckpt_block_s", 0.0)
            drain = self._acc.get("metric_drain_s", 0.0)
            step_compute = self._acc.get("step_compute_s", 0.0)
            if step_compute <= 0.0 and self._step_wall_s > 0.0:
                # Useful compute from step wall, less the waits measured in
                # the loop and the compile work done after the loop began.
                in_loop_compile = max(0.0, hooks_compile - (self._compile_preloop or 0.0))
                step_compute = max(0.0, self._step_wall_s - data - ckpt - in_loop_compile)
            idle = max(0.0, wall - (compile_s + data + step_compute + ckpt + drain))
            # Clamped: sub-resolution timing jitter must not report > 100%.
            goodput = min(1.0, step_compute / wall) if wall > 0 else 0.0
            mfu = (
                self.flops / (wall * self.peak_flops_per_s)
                if wall > 0 and self.peak_flops_per_s > 0
                else 0.0
            )
            tpds = (
                self.tokens / (wall * self.devices)
                if wall > 0 and self.devices > 0
                else 0.0
            )
            row: Dict[str, Any] = {
                "source": self.source,
                "process_id": self.process_id,
                "wall_s": wall,
                "buckets": {
                    "xla_compile_s": compile_s,
                    "data_wait_s": data,
                    "step_compute_s": step_compute,
                    "ckpt_block_s": ckpt,
                    "metric_drain_s": drain,
                    "idle_s": idle,
                },
                "steps": self.steps,
                "tokens": self.tokens,
                "flops": self.flops,
                "goodput": goodput,
                "mfu": mfu,
                "tokens_per_device_s": tpds,
                "compile_s": compile_s,
                "compile_events": compile_events,
                "compile_cache_hits": max(0, hits_now - self._cache0[0]),
                "compile_cache_misses": max(0, misses_now - self._cache0[1]),
                "hbm_peak_bytes": self._hbm_peak_bytes,
                "devices": self.devices,
                "device_kind": self.device_kind,
                "peak_flops_per_s": self.peak_flops_per_s,
            }
            if self._extra:
                row["extra"] = dict(self._extra)
            return row

    def maybe_flush(self) -> bool:
        """Throttled emit: call freely from hot loops."""
        if not self.armed or self.sink is None:
            return False
        now = time.perf_counter()
        with self._lock:
            if now - self._last_flush < self.interval_s:
                return False
        self.flush()
        return True

    def flush(self, final: bool = False) -> Optional[Dict[str, Any]]:
        """Emit one cumulative row through the sink (best-effort: the ledger
        must never be what kills a trainer)."""
        if not self.armed:
            return None
        self.sample_hbm()
        row = self.snapshot()
        with self._lock:
            self._seq += 1
            row["seq"] = self._seq
            self._last_flush = time.perf_counter()
        row["final"] = bool(final)
        if self.sink is not None:
            try:
                self.sink(row)
            except Exception:
                pass
        return row


_ledger = UtilizationLedger()


def get_ledger() -> UtilizationLedger:
    """The process-wide ledger (unconfigured: accounting only, no sink)."""
    return _ledger


def configure(**kwargs: Any) -> UtilizationLedger:
    """Configure the process-wide ledger (see :meth:`UtilizationLedger.configure`)."""
    return _ledger.configure(**kwargs)
