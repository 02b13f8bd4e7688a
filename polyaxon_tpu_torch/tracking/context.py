"""The run context handed to the port's entrypoints.

A counterpart of ``polyaxon_tpu/tracking/context.py``: params, seed,
leadership, the mesh and parallelism strategy, the run layout's paths
(outputs, checkpoints, data, the runs root) and metric / text logging.
With a ``reporter`` (``tracking/reporter.py``) metrics, text lines and a
service's URL go to the run's report file as typed lines, as the
reference's do; a ``records`` list the caller passes gets every metric and
text record as well, and without either they go to stdout as JSON lines.
``stop`` is how an in-process caller ends a service entrypoint
(``lm_server``) that otherwise serves until its process is killed.
"""

from __future__ import annotations

import json
import sys
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

from polyaxon_tpu_torch.tracking.reporter import Reporter


def _path(p: Optional[str]) -> Optional[Path]:
    return Path(p) if p else None


class Context:
    """What a ``module:function`` entrypoint receives as its only argument."""

    def __init__(
        self,
        *,
        params: Dict[str, Any],
        process_id: int = 0,
        num_processes: int = 1,
        mesh: Any = None,
        strategy: str = "ddp",
        strategy_options: Optional[Dict[str, Any]] = None,
        outputs_path: Optional[str] = None,
        checkpoints_path: Optional[str] = None,
        data_path: Optional[str] = None,
        runs_root: Optional[str] = None,
        reporter: Optional[Reporter] = None,
        seed: Optional[int] = None,
        run_uuid: Optional[str] = None,
        records: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        self.params = params
        self.process_id = process_id
        self.num_processes = num_processes
        #: The port's mesh (``runtime.mesh.build_mesh``); None lets an
        #: entrypoint build its own one-rank mesh.
        self.mesh = mesh
        #: The parallelism strategy's name and options (``parallel.templates``).
        self.strategy = strategy
        self.strategy_options = strategy_options or {}
        self.outputs_path = _path(outputs_path)
        self.checkpoints_path = _path(checkpoints_path)
        #: The store layout's shared data/ dir (registered datasets).
        self.data_path = _path(data_path)
        #: The layout's runs/ dir (entrypoints resolving a target run's files).
        self.runs_root = _path(runs_root)
        self.reporter = reporter
        self.seed = seed
        self.run_uuid = run_uuid
        #: Where log_metrics / log_text append; None (and no reporter) = stdout.
        self.records = records
        #: Set to ask a service entrypoint to shut down and return.
        self.stop = threading.Event()

    @property
    def is_leader(self) -> bool:
        """Process 0 — the one that reports."""
        return self.process_id == 0

    def _emit(self, record: Dict[str, Any]) -> None:
        if self.records is not None:
            self.records.append(record)
        elif self.reporter is None:
            print(json.dumps(record), file=sys.stdout, flush=True)

    def log_metrics(self, step: Optional[int] = None, **values: Any) -> None:
        if self.reporter is not None:
            self.reporter.metric(values, step=step)
        self._emit({"kind": "metric", "step": step, "values": values})

    def log_text(self, line: str) -> None:
        if self.reporter is not None:
            self.reporter.log(line)
        self._emit({"kind": "log", "line": line})

    def report_service(self, *, url: Optional[str] = None, query: Optional[str] = None) -> None:
        """Advertise or refine this run's service URL (``Reporter.service``);
        a no-op without a reporter."""
        if self.reporter is not None:
            self.reporter.service(url=url, query=query)

    def get_param(self, name: str, default: Any = None) -> Any:
        return self.params.get(name, default)
