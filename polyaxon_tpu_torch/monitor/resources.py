"""In-worker resource telemetry: the process and the card's memory.

The port's copy of ``polyaxon_tpu/monitor/resources.py``.  Each process
samples itself (CPU share, resident memory, threads; read from ``/proc``
with the standard library, where the reference uses psutil) and the memory
of the cards it has used, through ``torch.cuda.memory_stats``, and reports
them through the report channel as ``resources`` lines under the
reference's ``sys/`` keys, which the control plane's alerts read.

The reference's ``sample_tpu_utilization`` (a TPU's duty cycle) has no
counterpart: the card's utilization would come from NVML
(``torch.cuda.utilization()`` needs ``pynvml``), which the port does not
depend on.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

# cpu_percent is measured against the previous sample of the same pid (as
# psutil's cpu_percent(interval=None)): the first sample of a pid only
# primes it and reports no cpu row rather than a made-up zero.
_cpu_prev: Dict[int, Tuple[float, float]] = {}
_cpu_prev_lock = threading.Lock()
_TICKS = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _proc_sample(pid: int) -> Tuple[float, float, float]:
    """(cpu seconds, resident bytes, threads) of ``pid`` from ``/proc``."""
    with open(f"/proc/{pid}/stat") as fh:
        # The command name (field 2) may hold spaces: split after its ')'.
        fields = fh.read().rsplit(")", 1)[1].split()
    cpu_s = (int(fields[11]) + int(fields[12])) / _TICKS  # utime + stime
    rss = threads = 0.0
    with open(f"/proc/{pid}/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                rss = float(line.split()[1]) * 1024.0
            elif line.startswith("Threads:"):
                threads = float(line.split()[1])
    return cpu_s, rss, threads


def sample_process(pid: Optional[int] = None) -> Dict[str, float]:
    """CPU share, resident memory and threads of ``pid`` (default: this
    process) as ``sys/cpu_percent``, ``sys/rss_mb``, ``sys/threads``."""
    out: Dict[str, float] = {}
    key = os.getpid() if pid is None else pid
    try:
        cpu_s, rss, threads = _proc_sample(key)
        now = time.monotonic()
        with _cpu_prev_lock:
            prev = _cpu_prev.get(key)
            _cpu_prev[key] = (cpu_s, now)
        if prev is not None and now > prev[1]:
            out["sys/cpu_percent"] = 100.0 * (cpu_s - prev[0]) / (now - prev[1])
        out["sys/rss_mb"] = rss / 1e6
        out["sys/threads"] = threads
    except Exception:
        with _cpu_prev_lock:
            _cpu_prev.pop(key, None)  # gone (or reused): re-prime next time
        if pid is not None:
            return out  # the target is gone; report nothing rather than self
        try:
            import resource

            out["sys/rss_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3
        except Exception:
            pass
    return out


_device_lock = threading.Lock()
_hbm_peak_mb = 0.0


def _reset_device_probe() -> None:
    """Forget the high-water mark (tests; a process never needs this)."""
    global _hbm_peak_mb
    with _device_lock:
        _hbm_peak_mb = 0.0


def sample_devices() -> Dict[str, float]:
    """Memory of each card this process has used, from the caching
    allocator: ``sys/hbm{i}_mb`` (allocated now), ``sys/hbm{i}_peak_mb``
    (allocated at the peak), ``sys/hbm{i}_frac`` (allocated over the card's
    total from ``torch.cuda.mem_get_info``) and the aggregate high-water
    mark ``sys/hbm_peak_mb``.

    Returns ``{}`` until the process has initialized CUDA: a telemetry or
    watchdog thread must never be what creates a CUDA context.  A card the
    allocator has reserved nothing on is skipped for the same reason.
    """
    global _hbm_peak_mb
    out: Dict[str, float] = {}
    if not torch.cuda.is_initialized():
        return out
    total_peak_mb = 0.0
    got_any = False
    try:
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats.get("reserved_bytes.all.current") and \
                    not stats.get("reserved_bytes.all.peak"):
                continue
            in_use = stats.get("allocated_bytes.all.current", 0)
            peak = stats.get("allocated_bytes.all.peak", in_use)
            got_any = True
            out[f"sys/hbm{i}_mb"] = in_use / 1e6
            out[f"sys/hbm{i}_peak_mb"] = peak / 1e6
            total = torch.cuda.mem_get_info(i)[1]
            if total:
                out[f"sys/hbm{i}_frac"] = in_use / total
            total_peak_mb += peak / 1e6
    except Exception:
        pass
    if got_any:
        with _device_lock:
            _hbm_peak_mb = max(_hbm_peak_mb, total_peak_mb)
            out["sys/hbm_peak_mb"] = _hbm_peak_mb
    return out


class ResourceSampler:
    """Background thread reporting resource samples at an interval."""

    def __init__(self, reporter, interval: float = 10.0) -> None:
        self.reporter = reporter
        self.interval = interval
        #: When set, sample this pid instead of the calling process (a shell
        #: command's subprocess, so telemetry reflects the workload).
        self.pid: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> Dict[str, Any]:
        values = sample_process(self.pid)
        values.update(sample_devices())
        return values

    def start(self) -> None:
        if self._thread is not None or self.interval <= 0:
            return
        # Prime the cpu window now (unreported), so the first row the loop
        # emits measures a real interval.
        sample_process(self.pid)

        def loop() -> None:
            while not self._stop.wait(self.interval):
                values = self.sample_once()
                if values:
                    self.reporter.resources(values)

        self._thread = threading.Thread(target=loop, name="resources", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
