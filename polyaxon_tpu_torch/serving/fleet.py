"""Serving fleet: N ``lm_server`` replicas behind a :class:`FleetRouter`.

The port's own copy of :class:`LocalServingFleet` from
``polyaxon_tpu/serving/fleet.py``: replicas as real subprocesses
(``python -m polyaxon_tpu_torch.serving.replica``) through
``spawner.transport.LocalExecTransport``.  This is the fault-injection
harness: SIGKILL kills a replica mid-request (the failover path), SIGSTOP
freezes one without closing its sockets (the stall and ejection path).
The fleet implements the resize protocol :class:`FleetAutoscaler` drives
(``scale_up``, ``retire_replica``, ``run_id_for``) and a thread-free
``poll()`` pump.

The control plane's ``ServingFleet`` (replicas as ``kind: service`` registry
runs, drain-and-replace remediation, exemplar harvest) is not ported yet: it
needs the port's worker (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import polyaxon_tpu_torch
from polyaxon_tpu_torch.conf.knobs import knob_float, knob_int
from polyaxon_tpu_torch.serving.router import FleetRouter
from polyaxon_tpu_torch.spawner.transport import LocalExecTransport, _free_port
from polyaxon_tpu_torch.stats.metrics import labeled_key

__all__ = ["LocalServingFleet"]

#: Shared phase key with the scheduler's monitor-tick breakdown — the
#: autoscaler pump is one more control-plane phase on the same histogram.
_AUTOSCALER_PHASE_KEY = labeled_key("tick_phase_s", phase="autoscaler")


def _observe_autoscaler_phase(router: Any, seconds: float) -> None:
    try:
        router.metrics.observe(_AUTOSCALER_PHASE_KEY, seconds)
    except Exception:  # pragma: no cover - stats must never raise
        pass


class LocalServingFleet:
    """Subprocess replicas on this machine + a router fronting them.

    ``model`` is the ``TransformerConfig`` int-field dict each replica
    builds (random init, fixed ``seed`` — every replica serves identical
    weights, so greedy failover replays are token-identical).  ``device``
    (default ``"cuda"``) goes into every replica's spec, as does
    ``prefill_chunk`` (0 = whole prompts; the reference's spec key, which
    its fleet leaves at the replica's default).
    """

    def __init__(
        self,
        workdir: Path,
        model: Dict[str, int],
        *,
        replicas: Optional[int] = None,
        seq: int = 128,
        slots: int = 4,
        block_size: int = 16,
        kv_blocks: Optional[int] = None,
        prefill_chunk: int = 0,
        seed: int = 0,
        spec_decode: Optional[bool] = None,
        spec_k: Optional[int] = None,
        spec_min_ngram: Optional[int] = None,
        kv_offload: Optional[bool] = None,
        kv_offload_blocks: Optional[int] = None,
        kv_persist_dir: Optional[str] = None,
        kv_persist_sig: str = "",
        request_timeout_s: float = 600.0,
        host: str = "127.0.0.1",
        router: Optional[FleetRouter] = None,
        env: Optional[Dict[str, str]] = None,
        device: str = "cuda",
    ) -> None:
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.model = dict(model)
        self.replicas = (
            replicas
            if replicas is not None
            else knob_int("POLYAXON_TPU_FLEET_REPLICAS")
        )
        self.seq = seq
        self.slots = slots
        self.block_size = block_size
        self.kv_blocks = kv_blocks
        self.prefill_chunk = prefill_chunk
        self.seed = seed
        # Speculative decoding rides the replica spec (None = the
        # replica's own POLYAXON_TPU_SERVING_SPEC_* knob defaults).
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.spec_min_ngram = spec_min_ngram
        # KV hierarchy rides the spec too: every replica (including
        # autoscaler scale-ups, which re-enter launch_replica) shares
        # one kv_persist_dir, so a new replica boots prefix-warm from
        # whatever the incumbents last persisted.
        self.kv_offload = kv_offload
        self.kv_offload_blocks = kv_offload_blocks
        self.kv_persist_dir = kv_persist_dir
        self.kv_persist_sig = kv_persist_sig
        self.request_timeout_s = request_timeout_s
        self.host = host
        self.env = dict(env or {})
        self.device = device
        self.transport = LocalExecTransport()
        self.router = router if router is not None else FleetRouter()
        self._procs: Dict[str, Any] = {}
        self._counter = itertools.count()
        self.autoscaler: Optional[Any] = None

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "LocalServingFleet":
        for _ in range(self.replicas):
            self.launch_replica()
        self.router.start()
        return self

    def launch_replica(self, name: Optional[str] = None) -> str:
        name = name or f"r{next(self._counter)}"
        port = _free_port()
        spec = {
            "name": name,
            "host": self.host,
            "port": port,
            "seed": self.seed,
            "model": self.model,
            "seq": self.seq,
            "slots": self.slots,
            "block_size": self.block_size,
            "kv_blocks": self.kv_blocks,
            "prefill_chunk": self.prefill_chunk,
            "spec_decode": self.spec_decode,
            "spec_k": self.spec_k,
            "spec_min_ngram": self.spec_min_ngram,
            "kv_offload": self.kv_offload,
            "kv_offload_blocks": self.kv_offload_blocks,
            "kv_persist_dir": self.kv_persist_dir,
            "kv_persist_sig": self.kv_persist_sig,
            "request_timeout_s": self.request_timeout_s,
            "device": self.device,
        }
        spec_path = self.workdir / f"{name}.json"
        spec_path.write_text(json.dumps(spec))
        # The replica runs with cwd=workdir, so an uninstalled (source
        # checkout) polyaxon_tpu_torch must ride on PYTHONPATH explicitly.
        pkg_root = str(Path(polyaxon_tpu_torch.__file__).resolve().parent.parent)
        existing = os.environ.get("PYTHONPATH")
        env = dict(self.env)
        env.setdefault(
            "PYTHONPATH",
            pkg_root + (os.pathsep + existing if existing else ""),
        )
        ref = self.transport.launch(
            "localhost",
            [sys.executable, "-m", "polyaxon_tpu_torch.serving.replica", str(spec_path)],
            env,
            cwd=str(self.workdir),
            log_path=self.workdir / f"{name}.log",
            rc_path=self.workdir / f"{name}.rc",
        )
        self._procs[name] = ref
        self.router.add_replica(name, f"http://{self.host}:{port}")
        return name

    def wait_ready(
        self, n: Optional[int] = None, timeout_s: Optional[float] = None
    ) -> bool:
        """Block until ``n`` replicas probe ``ready`` (default: all)."""
        n = n if n is not None else len(self._procs)
        timeout_s = (
            timeout_s
            if timeout_s is not None
            else knob_float("POLYAXON_TPU_FLEET_READY_TIMEOUT_S")
        )
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            self.router.probe_all()
            if self.router.stats()["n_ready"] >= n:
                return True
            time.sleep(0.2)
        return False

    def stop(self) -> None:
        self.router.stop()
        for ref in self._procs.values():
            ref.signal(signal.SIGKILL)
        for ref in self._procs.values():
            ref.wait(timeout=10)
        self._procs.clear()

    # -- fault injection -------------------------------------------------------
    def kill_replica(self, name: str) -> None:
        """SIGKILL: sockets die mid-request — the failover path."""
        self._procs[name].signal(signal.SIGKILL)

    def stall_replica(self, name: str) -> None:
        """SIGSTOP: the process freezes with sockets OPEN — probes time
        out instead of failing fast, the ejection path's worst case."""
        self._procs[name].signal(signal.SIGSTOP)

    def resume_replica(self, name: str) -> None:
        self._procs[name].signal(signal.SIGCONT)

    def replace_replica(self, name: str) -> str:
        """Kill ``name`` (if alive), drop it from routing, launch a
        fresh replica — the local analogue of drain-and-replace."""
        self.retire_replica(name)
        return self.launch_replica()

    def chaos_target(self) -> Optional[str]:
        """Deterministic victim for an untargeted chaos event: the
        first (by name) ready replica the router still routes to."""
        ready = sorted(
            n
            for n in self.router.replica_names()
            if (r := self.router.replica(n)) is not None
            and r.state == "ready"
            and n in self._procs
        )
        return ready[0] if ready else None

    # -- resize protocol (FleetAutoscaler) -------------------------------------
    def scale_up(self) -> str:
        return self.launch_replica()

    def retire_replica(self, name: str) -> None:
        ref = self._procs.pop(name, None)
        if ref is not None:
            ref.signal(signal.SIGKILL)
            ref.wait(timeout=10)
        self.router.remove_replica(name)

    def run_id_for(self, name: str) -> Optional[int]:
        return None  # subprocess replicas have no registry run

    def attach_autoscaler(self, **kwargs: Any) -> Any:
        from polyaxon_tpu_torch.serving.autoscaler import FleetAutoscaler

        self.autoscaler = FleetAutoscaler(self, **kwargs)
        return self.autoscaler

    def poll(self) -> None:
        """Thread-free pump: reap
        replicas whose subprocess died out from under us (a SIGKILLed
        corpse would otherwise sit ejected forever, pinning autoscaler
        membership at a capacity the router cannot route to), probe
        when no router thread owns it, then tick the autoscaler."""
        for name, ref in list(self._procs.items()):
            if ref.poll() is not None:
                self.retire_replica(name)
        if getattr(self.router, "_thread", None) is None:
            self.router.probe_all()
        if self.autoscaler is not None:
            t0 = time.perf_counter()
            try:
                self.autoscaler.evaluate()
            finally:
                _observe_autoscaler_phase(
                    self.router, time.perf_counter() - t0
                )
