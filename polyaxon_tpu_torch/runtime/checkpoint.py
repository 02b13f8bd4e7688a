"""Checkpoint and restore of training state.

Counterpart of ``polyaxon_tpu/runtime/checkpoint.py``, written for PyTorch
tensors: the same ``.complete/<step>`` finalize markers and
``latest_complete_step`` (what the control plane asks "where can this run
resume from"), the same save policy and fences, and ``CheckpointNowService``
for the command bus.  The on-disk layout is the port's own:

- a step is the directory ``<step>/`` holding ``params.pt`` and
  ``opt_state.pt`` (``torch.save`` of a flat ``{tree path: tensor}`` dict,
  read back with ``weights_only=True``) and ``meta.json`` (each leaf's
  shape and dtype, per item), so a weights-only restore reads only
  ``params.pt``;
- a step is written under the non-digit name ``<step>.tmp`` and renamed
  into place once its files are complete, so digit-named directories are
  always whole;
- the marker ``.complete/<step>`` goes through tmp + rename too, and only
  for a step this process saved: a fresh process never blesses a step
  directory a crashed predecessor left.

``AdamWState`` is saved whole (``count``, ``mu``, ``nu``), each tensor in
its own dtype.  The reference's orbax directories are not read: the port
imports no orbax.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Union

import torch

from polyaxon_tpu_torch.runtime.optim import AdamWState

#: Dot-named so a digit-dir step scan never mistakes it for a step.
_COMPLETE_DIR = ".complete"
_ITEMS = ("params", "opt_state")


def latest_complete_step(directory: Union[str, Path]) -> Optional[int]:
    """Latest step with a finalize marker — pure filesystem, so the
    control plane can answer "where can this run resume from" without
    touching the accelerator runtime.

    Checkpoint dirs written before finalize markers existed (no
    ``.complete/``) fall back to trusting the digit-named step dirs, the
    pre-marker behavior.
    """
    directory = Path(directory)
    if not directory.is_dir():
        return None
    steps = {int(p.name) for p in directory.iterdir() if p.name.isdigit()}
    if not steps:
        return None
    marks_dir = directory / _COMPLETE_DIR
    if marks_dir.is_dir():
        marked = {int(p.name) for p in marks_dir.iterdir() if p.name.isdigit()}
        steps &= marked
    return max(steps) if steps else None


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of nested dicts, lists and tuples; an ``AdamWState``
    is ``{"count": <int64 scalar tensor>, "mu": [...], "nu": [...]}``."""
    if isinstance(tree, AdamWState):
        tree = {"count": torch.tensor(tree.count, dtype=torch.int64),
                "mu": tree.mu, "nu": tree.nu}
    if isinstance(tree, dict):
        pairs = tree.items()
    elif isinstance(tree, (list, tuple)):
        pairs = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, value in pairs:
        out.update(_flatten(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _describe(flat: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    return {path: {"shape": list(t.shape), "dtype": _dtype_name(t.dtype)}
            for path, t in flat.items()}


class CheckpointManager:
    """Save and restore ``(params, opt_state)`` by step under ``directory``.

    Saves are asynchronous by default (``enable_async=True``): :meth:`save`
    copies every leaf off the live tensors before it returns (the optimizer
    updates params, mu and nu in place, so a later copy could see the next
    step), and a background thread serializes the copies.  On the card the
    copies land in pinned host buffers that are kept for the next save; on
    the CPU they are clones.  One save is in flight at a time: a save first
    waits for the previous one.  Every restore, :meth:`latest_step`,
    :meth:`wait_until_finished` and :meth:`close` first fence in-flight
    writes.

    When a step is saved follows the reference's orbax policy: with
    ``force=False``, a step whose index ``save_interval_steps`` divides and
    that is later than every step already saved (step 0 included);
    ``max_to_keep`` keeps the newest step directories (None or 0 keeps all)
    and the fence drops the markers of pruned ones.  A step dir without a
    marker that this process did not save (a process died before marking
    it) counts as not saved: saving its step replaces it.

    :attr:`save_block_s` accumulates the seconds :meth:`save` blocked the
    caller (the copies plus any wait for the previous write); :attr:`history`
    holds one ``{"step", "block_s", "bytes", "write_s"}`` per save, with
    ``write_s`` set when its write has finished.
    """

    def __init__(
        self,
        directory: Union[str, Path],
        *,
        max_to_keep: int = 3,
        save_interval_steps: int = 1,
        enable_async: bool = True,
    ) -> None:
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        # Eager, so a crash before the first marker leaves an EMPTY marker
        # dir (torn step dirs rejected) rather than no dir (legacy-trust).
        (self.directory / _COMPLETE_DIR).mkdir(exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.enable_async = enable_async
        self.save_block_s = 0.0
        self.saves = 0
        self.history: List[Dict[str, Any]] = []
        #: Steps this process saved whose finalize marker isn't written yet.
        self._pending_marks: Set[int] = set()
        self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint-writer")
        self._inflight: Optional[Future] = None
        self._inflight_step: Optional[int] = None
        #: Pinned host buffers by (item, path), reused across saves.
        self._pinned: Dict[tuple, torch.Tensor] = {}

    # -- save -----------------------------------------------------------------
    def _steps_on_disk(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and p.is_dir())

    def _saved_steps(self) -> Set[int]:
        """Complete steps, and the steps this process saved (in flight or
        not yet marked); not a step dir a dead process left unmarked."""
        known = set(self._complete_steps()) | self._pending_marks
        if self._inflight_step is not None:
            known.add(self._inflight_step)
        return known

    def _should_save(self, step: int) -> bool:
        known = self._saved_steps()
        if known and max(known) >= step:
            return False
        return step % self.save_interval_steps == 0

    def save(self, step: int, params: Any, opt_state: Any, force: bool = False) -> bool:
        """Save training state at ``step``; returns whether a save happened.
        Raises ``ValueError`` if ``step`` is already saved (as orbax does,
        ``force`` included)."""
        t0 = time.perf_counter()
        try:
            if not force and not self._should_save(step):
                return False
            self._wait_writer()
            # The previous write has committed, so its marker can be written.
            self._mark_committed()
            if step in self._saved_steps():
                raise ValueError(f"Checkpoint for step {step} already exists.")
            staged = {item: self._stage(item, tree)
                      for item, tree in zip(_ITEMS, (params, opt_state))}
            record = {"step": step, "bytes": sum(t.numel() * t.element_size()
                                                 for flat in staged.values()
                                                 for t in flat.values()),
                      "write_s": None}
            self.history.append(record)
            self._pending_marks.add(step)
            self._inflight_step = step
            self._inflight = self._writer.submit(self._write, step, staged, record)
            if not self.enable_async:
                self._wait_writer()
            self.saves += 1
            record["block_s"] = time.perf_counter() - t0
            return True
        finally:
            self.save_block_s += time.perf_counter() - t0

    def _stage(self, item: str, tree: Any) -> Dict[str, torch.Tensor]:
        """Host copies of every leaf, complete when this returns."""
        flat = _flatten(tree)
        out: Dict[str, torch.Tensor] = {}
        on_card = False
        with torch.no_grad():
            for path, leaf in flat.items():
                leaf = leaf.detach()
                if leaf.is_cuda:
                    buf = self._pinned.get((item, path))
                    if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
                        buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
                        self._pinned[(item, path)] = buf
                    buf.copy_(leaf, non_blocking=True)
                    out[path] = buf
                    on_card = True
                else:
                    out[path] = leaf.clone()
        if on_card:
            torch.cuda.synchronize()
        return out

    def _write(self, step: int, staged: Dict[str, Dict[str, torch.Tensor]],
               record: Dict[str, Any]) -> None:
        """Writer thread: the step's files under a temporary name, then the
        rename that makes it a step, then pruning."""
        t0 = time.perf_counter()
        for stale in self.directory.glob("*.tmp"):  # left by a writer that died
            shutil.rmtree(stale, ignore_errors=True)
        tmp = self.directory / f"{step}.tmp"
        tmp.mkdir()
        for item, flat in staged.items():
            torch.save(flat, tmp / f"{item}.pt")
        meta = {item: _describe(flat) for item, flat in staged.items()}
        (tmp / "meta.json").write_text(json.dumps(meta))
        final = self.directory / str(step)
        shutil.rmtree(final, ignore_errors=True)  # an unmarked dir a dead process left
        tmp.rename(final)
        if self.max_to_keep:
            for old in self._steps_on_disk()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
        record["write_s"] = time.perf_counter() - t0

    def _wait_writer(self) -> None:
        inflight, self._inflight = self._inflight, None
        self._inflight_step = None
        if inflight is not None:
            inflight.result()  # re-raises a failed write

    def _write_marker(self, step: int) -> None:
        """Atomic finalize marker (tmp + rename: a crash leaves a valid
        marker or none, never a torn one)."""
        marks = self.directory / _COMPLETE_DIR
        marks.mkdir(exist_ok=True)
        tmp = marks / f".tmp.{step}"
        tmp.write_text("")
        tmp.rename(marks / str(step))

    def _mark_committed(self) -> None:
        for s in sorted(self._pending_marks):
            if (self.directory / str(s)).is_dir():
                self._write_marker(s)
            self._pending_marks.discard(s)

    def _fence(self) -> None:
        """Drain the in-flight write, finalize its marker, and drop markers
        whose step dirs ``max_to_keep`` pruned away."""
        self._wait_writer()
        self._mark_committed()
        on_disk = set(self._steps_on_disk())
        for p in (self.directory / _COMPLETE_DIR).iterdir():
            if p.name.isdigit() and int(p.name) not in on_disk:
                p.unlink(missing_ok=True)

    # -- restore --------------------------------------------------------------
    def _complete_steps(self) -> List[int]:
        steps = self._steps_on_disk()
        marks = self.directory / _COMPLETE_DIR
        if not marks.is_dir():
            return steps  # a pre-marker dir: trust the digit dirs
        marked = {int(p.name) for p in marks.iterdir() if p.name.isdigit()}
        return [s for s in steps if s in marked]

    def latest_step(self) -> Optional[int]:
        """Newest step with a finalize marker, after fencing in-flight writes."""
        self._fence()
        steps = self._complete_steps()
        return steps[-1] if steps else None

    def _load_into(self, step: int, item: str, template: Any) -> Any:
        """Copy ``item`` of ``step`` into the template's tensors (keeping
        each one's device and dtype); raises ``ValueError`` naming the leaf
        on a missing or extra key, a shape or a dtype that differs."""
        step_dir = self.directory / str(step)
        saved = json.loads((step_dir / "meta.json").read_text())[item]
        flat = _flatten(template)
        for path in sorted(set(saved) | set(flat)):
            if path not in flat:
                raise ValueError(f"{item} leaf {path!r} is in step {step} but not in the template")
            if path not in saved:
                raise ValueError(f"{item} leaf {path!r} is in the template but not in step {step}")
            want = {"shape": list(flat[path].shape), "dtype": _dtype_name(flat[path].dtype)}
            if saved[path] != want:
                raise ValueError(f"{item} leaf {path!r}: step {step} holds {saved[path]}, "
                                 f"the template {want}")
        loaded = torch.load(step_dir / f"{item}.pt", map_location="cpu", weights_only=True,
                            mmap=True)
        with torch.no_grad():
            for path, leaf in flat.items():
                leaf.copy_(loaded[path])
        if isinstance(template, AdamWState):
            template.count = int(flat["count"])
        return template

    def restore_params(self, params_template: Any,
                       step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Restore only the weights (the inference path: no optimizer
        template, no optimizer IO), into ``params_template``'s tensors.
        None when there is no complete step."""
        self._fence()
        step = step if step is not None else self._latest_complete()
        if step is None:
            return None
        return {"params": self._load_into(step, "params", params_template), "step": step}

    def restore(self, params_template: Any, opt_state_template: Any,
                step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Restore weights and optimizer state into the templates' tensors;
        None when there is no complete step."""
        self._fence()
        step = step if step is not None else self._latest_complete()
        if step is None:
            return None
        return {"params": self._load_into(step, "params", params_template),
                "opt_state": self._load_into(step, "opt_state", opt_state_template),
                "step": step}

    def _latest_complete(self) -> Optional[int]:
        steps = self._complete_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        """Block until the in-flight write has committed and its finalize
        marker is durable."""
        self._fence()

    def close(self) -> None:
        """Fence (never truncate an in-flight save), stop the writer thread
        and release the pinned buffers."""
        self._fence()
        self._writer.shutdown(wait=True)
        self._pinned.clear()


class CheckpointNowService:
    """Worker-side ``checkpoint-now`` command handler: the bridge between
    the command bus (its poll thread) and the train loop.

    The bus handler only QUEUES — the optimizer changes the state in place,
    so the save must run on the loop thread between steps.  The train loop
    calls :meth:`maybe_save` once per step; when commands are pending it
    forces a save, fences it (marker durable — the point of checkpoint-now
    is surviving what comes next), and acks each command ``complete`` with
    the saved step in its attrs.
    """

    def __init__(self, ckpt: CheckpointManager, agent: Any) -> None:
        self._ckpt = ckpt
        self._agent = agent
        self._lock = threading.Lock()
        self._pending: List[str] = []
        agent.register_handler("checkpoint-now", self._on_command)

    def _on_command(self, cmd: Dict[str, Any]) -> None:
        # Poll thread: just enqueue (the "acked" event is already out).
        with self._lock:
            self._pending.append(str(cmd.get("uuid") or ""))

    def maybe_save(self, step: int, params: Any, opt_state: Any) -> bool:
        """Train-loop hook; near-free when nothing is pending."""
        if not self._pending:
            return False
        with self._lock:
            uuids, self._pending = self._pending, []
        try:
            try:
                self._ckpt.save(step, params, opt_state, force=True)
            except ValueError:
                # Step already saved by the interval policy — fencing the
                # existing save below is all the command asked for.
                pass
            self._ckpt.wait_until_finished()
            saved = self._ckpt.latest_step()
        except Exception as exc:  # keep training alive; fail the command
            for uuid in uuids:
                if uuid:
                    self._agent.command_event(uuid, "failed", message=f"checkpoint-now: {exc}")
            return False
        for uuid in uuids:
            if uuid:
                self._agent.command_event(uuid, "complete", step=saved)
        return True
