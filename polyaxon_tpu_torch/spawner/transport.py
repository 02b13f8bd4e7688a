"""Spawner transports: how a process reaches its host.

The port's own copy of the local half of
``polyaxon_tpu/spawner/transport.py``: the ``launch / poll / signal`` seam
(:class:`Transport`, :class:`ProcessRef`) and :class:`LocalExecTransport`,
subprocesses on this machine.  Every process is launched as a session
leader (``start_new_session``), so a signal reaches its whole tree, with
stdout and stderr appended to ``log_path``.  The SSH transport and
``reattach`` (restart recovery of a control plane) wait for the port's
worker and spawner (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import os
import socket
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence


def _free_port() -> int:
    """A TCP port free on the loopback now (the reference keeps this in
    ``spawner/local.py``)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ProcessRef:
    """A launched process as seen by the control plane."""

    #: Host-local pid (also the process-group id: transports launch every
    #: process as a session leader so signals take down the whole tree).
    pid: int

    def poll(self) -> Optional[int]:  # pragma: no cover - interface
        """Exit code, or None while running."""
        raise NotImplementedError

    def signal(self, sig: int) -> None:  # pragma: no cover - interface
        """Deliver ``sig`` to the process group (non-blocking)."""
        raise NotImplementedError

    def wait(self, timeout: float) -> Optional[int]:  # pragma: no cover
        """Block up to ``timeout`` for exit; return the code or None."""
        raise NotImplementedError


class Transport:
    """Launches processes on a host.  One instance serves many launches."""

    def launch(
        self,
        host: str,
        argv: Sequence[str],
        env: Dict[str, str],
        *,
        cwd: str,
        log_path: Path,
        rc_path: Path,
        unset_prefixes: Sequence[str] = (),
    ) -> ProcessRef:  # pragma: no cover - interface
        """Start ``argv`` on ``host`` with ``env`` exported (None values =
        unset), stdout+stderr appended to ``log_path``, exit code written to
        ``rc_path``.  ``unset_prefixes`` strips matching vars from the
        host's own environment."""
        raise NotImplementedError


class _LocalProcessRef(ProcessRef):
    def __init__(self, proc: subprocess.Popen) -> None:
        self._proc = proc
        self.pid = proc.pid

    def poll(self) -> Optional[int]:
        return self._proc.poll()

    def signal(self, sig: int) -> None:
        try:
            os.killpg(self.pid, sig)  # pgid == pid (start_new_session)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                self._proc.send_signal(sig)
            except (ProcessLookupError, OSError):
                pass

    def wait(self, timeout: float) -> Optional[int]:
        try:
            return self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None


class LocalExecTransport(Transport):
    """Subprocesses on the control-plane machine (ignores ``host``).

    Inherits this process's ``os.environ`` under the overrides: local
    processes need the same interpreter setup (PATH, venv) as their parent.
    """

    def launch(
        self,
        host: str,
        argv: Sequence[str],
        env: Dict[str, str],
        *,
        cwd: str,
        log_path: Path,
        rc_path: Path,
        unset_prefixes: Sequence[str] = (),
    ) -> ProcessRef:
        full_env = dict(os.environ)
        for prefix in unset_prefixes:
            for key in list(full_env):
                if key.startswith(prefix):
                    full_env.pop(key)
        # A caller may delete inherited variables: None means "unset".
        for key, value in env.items():
            if value is None:
                full_env.pop(key, None)
            else:
                full_env[key] = value
        log_path.parent.mkdir(parents=True, exist_ok=True)
        log_fh = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                list(argv),
                env={k: v for k, v in full_env.items() if v is not None},
                stdout=log_fh,
                stderr=subprocess.STDOUT,
                cwd=cwd,
                start_new_session=True,
            )
        finally:
            log_fh.close()  # the child holds its own descriptor
        return _LocalProcessRef(proc)
