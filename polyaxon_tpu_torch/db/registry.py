"""The port's copy of ``polyaxon_tpu/db/registry.py``: the same tables,
rows, statuses, messages and operations.  ``Run.spec`` validates through
the port's specifications (see there).

Durable run registry: the control plane's single source of truth.

Capability parity with the reference's Postgres models + Redis ephemeral
state:

- runs table        ~ ``db/models/experiments.py:48`` (``Experiment``) and the
                      other entity models (jobs, groups, pipelines) folded into
                      one polymorphic table keyed by ``kind``;
- statuses table    ~ per-entity ``*Status`` models
                      (``db/models/experiments.py:419``), with every write
                      gated by the lifecycle machine the way the reference
                      checks ``can_transition``
                      (``scheduler/tasks/experiments.py:72-77``);
- metrics table +   ~ ``ExperimentMetric`` rows + ``Experiment.set_metric``
  ``last_metric``     merging into JSONB (``db/models/experiments.py:294-298``);
- logs table        ~ the logs store written by ``logs_handlers/``;
- heartbeats        ~ ``db/redis/heartbeat.py`` (``RedisHeartBeat``);
- iterations        ~ ``ExperimentGroupIteration``
                      (``db/models/experiment_groups.py:414``);
- processes         ~ ``ExperimentJob`` rows (the replica unit,
                      ``db/models/experiment_jobs.py``) — here a gang's host
                      processes;
- activity table    ~ ``activitylogs/``;
- options table     ~ the DB-backed store of ``options/option.py:13-40``.

Differences from the reference: sqlite (WAL) instead of Postgres+Redis — the control
plane is a single service and workers report through run-dir files, so one
embedded, multi-process-safe database replaces both; statuses/metrics/logs
are ordinary rows so the streaming layer can tail them with a cursor.
"""

from __future__ import annotations

import functools
import json
import math
import sqlite3
import threading
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from polyaxon_tpu_torch.exceptions import PolyaxonTPUError
from polyaxon_tpu_torch.lifecycles import StatusOptions as S, lifecycle_for_kind
from polyaxon_tpu_torch.stats.metrics import labeled_key, split_labeled_key
from polyaxon_tpu_torch.schemas.specifications import (
    BaseSpecification,
    specification_for_kind,
)


class RegistryError(PolyaxonTPUError):
    pass


_SCHEMA = """
CREATE TABLE IF NOT EXISTS runs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    uuid TEXT UNIQUE NOT NULL,
    kind TEXT NOT NULL,
    name TEXT,
    project TEXT NOT NULL DEFAULT 'default',
    spec TEXT NOT NULL,
    status TEXT NOT NULL,
    group_id INTEGER,
    pipeline_id INTEGER,
    original_id INTEGER,
    cloning_strategy TEXT,
    restarts INTEGER NOT NULL DEFAULT 0,
    tags TEXT NOT NULL DEFAULT '[]',
    last_metric TEXT NOT NULL DEFAULT '{}',
    outputs_path TEXT,
    code_ref TEXT,
    service_url TEXT,
    meta TEXT NOT NULL DEFAULT '{}',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    started_at REAL,
    finished_at REAL,
    archived_at REAL
);
CREATE INDEX IF NOT EXISTS ix_runs_kind ON runs (kind);
CREATE INDEX IF NOT EXISTS ix_runs_group ON runs (group_id);
CREATE INDEX IF NOT EXISTS ix_runs_status ON runs (status);

CREATE TABLE IF NOT EXISTS statuses (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    status TEXT NOT NULL,
    message TEXT,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_statuses_run ON statuses (run_id);

CREATE TABLE IF NOT EXISTS metrics (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    step INTEGER,
    vals TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_metrics_run ON metrics (run_id);

CREATE TABLE IF NOT EXISTS logs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    process_id INTEGER,
    line TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_logs_run ON logs (run_id);

CREATE TABLE IF NOT EXISTS spans (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    process_id INTEGER,
    trace_id TEXT,
    span_id TEXT,
    parent_id TEXT,
    name TEXT NOT NULL,
    thread TEXT,
    start REAL NOT NULL,
    duration REAL NOT NULL,
    attrs TEXT,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_spans_run ON spans (run_id);

CREATE TABLE IF NOT EXISTS heartbeats (
    run_id INTEGER PRIMARY KEY,
    last_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS progress (
    run_id INTEGER NOT NULL,
    process_id INTEGER NOT NULL,
    step INTEGER,
    epoch INTEGER,
    throughput REAL,
    at REAL NOT NULL,
    updated_at REAL NOT NULL,
    PRIMARY KEY (run_id, process_id)
);

CREATE TABLE IF NOT EXISTS anomalies (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    process_id INTEGER,
    kind TEXT NOT NULL,
    message TEXT,
    attrs TEXT,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_anomalies_run ON anomalies (run_id);

CREATE TABLE IF NOT EXISTS utilization (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    process_id INTEGER,
    seq INTEGER,
    source TEXT,
    wall_s REAL,
    buckets TEXT,
    steps INTEGER,
    tokens INTEGER,
    flops REAL,
    goodput REAL,
    mfu REAL,
    tokens_per_device_s REAL,
    compile_s REAL,
    compile_events INTEGER,
    hbm_peak_bytes REAL,
    devices INTEGER,
    device_kind TEXT,
    peak_flops_per_s REAL,
    final INTEGER NOT NULL DEFAULT 0,
    attrs TEXT,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_utilization_run ON utilization (run_id);

CREATE TABLE IF NOT EXISTS iterations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    group_id INTEGER NOT NULL,
    number INTEGER NOT NULL,
    data TEXT NOT NULL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE (group_id, number)
);

CREATE TABLE IF NOT EXISTS processes (
    run_id INTEGER NOT NULL,
    process_id INTEGER NOT NULL,
    pid INTEGER,
    status TEXT NOT NULL,
    exit_code INTEGER,
    report_offset INTEGER NOT NULL DEFAULT 0,
    updated_at REAL NOT NULL,
    PRIMARY KEY (run_id, process_id)
);

CREATE TABLE IF NOT EXISTS activity (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    event_type TEXT NOT NULL,
    context TEXT NOT NULL,
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS options (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);

CREATE TABLE IF NOT EXISTS projects (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    description TEXT,
    owner TEXT,
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS project_collaborators (
    project_name TEXT NOT NULL,
    username TEXT NOT NULL,
    created_at REAL NOT NULL,
    PRIMARY KEY (project_name, username)
);

CREATE TABLE IF NOT EXISTS chart_views (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    name TEXT NOT NULL,
    charts TEXT NOT NULL,
    meta TEXT NOT NULL DEFAULT '{}',
    owner TEXT,
    created_at REAL NOT NULL,
    UNIQUE (run_id, name)
);

CREATE TABLE IF NOT EXISTS project_ci (
    project_name TEXT PRIMARY KEY,
    spec TEXT NOT NULL,
    last_code_ref TEXT,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS searches (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    query TEXT NOT NULL,
    owner TEXT,
    created_at REAL NOT NULL
);

CREATE TABLE IF NOT EXISTS bookmarks (
    run_id INTEGER NOT NULL,
    owner TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL,
    PRIMARY KEY (run_id, owner)
);

CREATE TABLE IF NOT EXISTS users (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    username TEXT UNIQUE NOT NULL,
    token_hash TEXT UNIQUE NOT NULL,
    role TEXT NOT NULL DEFAULT 'user',
    created_at REAL NOT NULL,
    last_used_at REAL
);

CREATE TABLE IF NOT EXISTS devices (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    accelerator TEXT NOT NULL,
    chips INTEGER NOT NULL,
    num_hosts INTEGER NOT NULL DEFAULT 1,
    run_id INTEGER,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_devices_family ON devices (accelerator);

CREATE TABLE IF NOT EXISTS device_claims (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    device_id INTEGER NOT NULL REFERENCES devices (id) ON DELETE CASCADE,
    run_id INTEGER NOT NULL,
    chips INTEGER NOT NULL,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_claims_device ON device_claims (device_id);
CREATE INDEX IF NOT EXISTS ix_claims_run ON device_claims (run_id);

CREATE TABLE IF NOT EXISTS commands (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    uuid TEXT UNIQUE NOT NULL,
    kind TEXT NOT NULL,
    process_id INTEGER,
    payload TEXT NOT NULL DEFAULT '{}',
    status TEXT NOT NULL,
    message TEXT,
    acks TEXT NOT NULL DEFAULT '{}',
    expected INTEGER NOT NULL DEFAULT 1,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_commands_run ON commands (run_id);

CREATE TABLE IF NOT EXISTS captures (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    capture_id TEXT NOT NULL,
    process_id INTEGER NOT NULL,
    status TEXT NOT NULL,
    start_step INTEGER,
    num_steps INTEGER,
    started_at REAL,
    finished_at REAL,
    artifacts TEXT NOT NULL DEFAULT '[]',
    message TEXT,
    attrs TEXT,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE (run_id, capture_id, process_id)
);
CREATE INDEX IF NOT EXISTS ix_captures_run ON captures (run_id);

CREATE TABLE IF NOT EXISTS alerts (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    rule TEXT NOT NULL,
    state TEXT NOT NULL,
    severity TEXT NOT NULL,
    message TEXT,
    value REAL,
    for_s REAL,
    episodes INTEGER NOT NULL DEFAULT 0,
    pending_since REAL,
    fired_at REAL,
    resolved_at REAL,
    attrs TEXT,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE (run_id, rule)
);
CREATE INDEX IF NOT EXISTS ix_alerts_run ON alerts (run_id);

CREATE TABLE IF NOT EXISTS remediations (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    run_id INTEGER NOT NULL,
    action TEXT NOT NULL,
    trigger TEXT,
    status TEXT NOT NULL,
    message TEXT,
    attrs TEXT,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_remediations_run ON remediations (run_id);

CREATE TABLE IF NOT EXISTS metric_samples (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    run_id INTEGER,
    at REAL NOT NULL,
    value REAL NOT NULL,
    agg TEXT NOT NULL DEFAULT 'raw',
    vmin REAL,
    vmax REAL,
    vsum REAL,
    vcount INTEGER,
    created_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS ix_metric_samples_name ON metric_samples (name, at);
CREATE INDEX IF NOT EXISTS ix_metric_samples_run ON metric_samples (run_id);

CREATE TABLE IF NOT EXISTS metric_baselines (
    project TEXT NOT NULL,
    kind TEXT NOT NULL,
    series TEXT NOT NULL,
    ewma REAL NOT NULL,
    ewvar REAL NOT NULL DEFAULT 0,
    count INTEGER NOT NULL DEFAULT 0,
    last_value REAL,
    last_run_id INTEGER,
    updated_at REAL NOT NULL,
    PRIMARY KEY (project, kind, series)
);
"""


class CommandStatus:
    """Lifecycle of a worker-directed command (the run command bus).

    PENDING (enqueued, mailbox files written) → ACKED (at least one worker
    picked it up) → COMPLETE/FAILED (every targeted worker reported a
    terminal per-process state).  EXPIRED is the control plane's own
    verdict: the run finished (or was already finished) before the gang
    honored the command — a typed answer instead of a hang.
    """

    PENDING = "pending"
    ACKED = "acked"
    COMPLETE = "complete"
    FAILED = "failed"
    EXPIRED = "expired"

    TERMINAL = (COMPLETE, FAILED, EXPIRED)


def command_ack_state(ack: Any) -> Optional[str]:
    """The per-process state of an ``acks`` value — plain string for
    attr-less acks, ``{"state":..., "attrs":...}`` dicts otherwise."""
    if isinstance(ack, dict):
        return ack.get("state")
    return ack


def command_ack_attrs(ack: Any) -> Dict[str, Any]:
    """Handler result attrs folded into an ``acks`` value ({} if none)."""
    if isinstance(ack, dict):
        return ack.get("attrs") or {}
    return {}


class AlertState:
    """Lifecycle of an alert-rule evaluation (Alertmanager-shaped).

    PENDING (predicate violated, inside the ``for_s`` hold-down) → FIRING
    (held long enough; notifications routed) → RESOLVED (predicate healthy
    again, or the run finished mid-episode).  A pending alert that recovers
    before the hold-down elapses is dropped silently — that is the flap
    suppression.  One row per (run, rule) holds the latest state; every
    state *transition* re-inserts the row with a fresh id so since_id
    pagers and the WS tail see transitions, not steady-state churn.
    """

    PENDING = "pending"
    FIRING = "firing"
    RESOLVED = "resolved"

    ACTIVE = (PENDING, FIRING)


class AlertSeverity:
    INFO = "info"
    WARNING = "warning"
    CRITICAL = "critical"

    ALL = (INFO, WARNING, CRITICAL)


class RemediationStatus:
    """Lifecycle of a remediation action (the detection→action loop).

    PENDING (decided, not yet acting) → IN_PROGRESS (command issued /
    process signalled) → SUCCEEDED / FAILED.  SKIPPED records a decision
    *not* to act (budget exhausted, topology not shrinkable) so the run's
    timeline explains inaction; EXPIRED is the control plane closing rows
    left open when the run reached a terminal state.
    """

    PENDING = "pending"
    IN_PROGRESS = "in_progress"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    SKIPPED = "skipped"
    EXPIRED = "expired"

    OPEN = (PENDING, IN_PROGRESS)
    TERMINAL = (SUCCEEDED, FAILED, SKIPPED, EXPIRED)


def accelerator_family(accelerator: str) -> str:
    """``v5e-16`` → ``v5e``; ``cpu``/``cpu-1`` → ``cpu`` — the platform
    generation a gang can actually run on (chips aren't fungible across
    generations the way the reference's ``NodeGPU`` count was)."""
    return accelerator.split("-", 1)[0]


@dataclass
class Run:
    """A registry row. ``spec`` is lazily parsed into a typed specification."""

    id: int
    uuid: str
    kind: str
    name: Optional[str]
    project: str
    status: str
    spec_data: Dict[str, Any]
    group_id: Optional[int] = None
    pipeline_id: Optional[int] = None
    original_id: Optional[int] = None
    cloning_strategy: Optional[str] = None
    restarts: int = 0
    tags: List[str] = field(default_factory=list)
    last_metric: Dict[str, Any] = field(default_factory=dict)
    outputs_path: Optional[str] = None
    code_ref: Optional[str] = None
    #: Reachable URL of a serving service gang (notebook/tensorboard kinds).
    service_url: Optional[str] = None
    #: Control-plane scratch attrs surviving restarts (e.g. the ``elastic``
    #: topology override recorded by straggler eviction).
    meta: Dict[str, Any] = field(default_factory=dict)
    created_at: float = 0.0
    updated_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    #: Set = hidden from default listings, eligible for the retention
    #: purge cron (reference archived managers + ``crons/tasks/deletion.py``).
    archived_at: Optional[float] = None

    @property
    def spec(self) -> BaseSpecification:
        """The typed specification.  The port validates the kinds a gang
        worker runs; on a group or pipeline row (kinds the control plane
        expands, whose schemas the port does not hold yet) it raises the
        port's ``SchemaError``: such rows are stored and listed all the
        same."""
        cls = specification_for_kind(self.kind)
        return cls.from_dict(self.spec_data)

    @property
    def lifecycle(self):
        return lifecycle_for_kind(self.kind)

    @property
    def is_done(self) -> bool:
        return self.lifecycle.is_done(self.status)


def _row_to_run(row: sqlite3.Row) -> Run:
    return Run(
        id=row["id"],
        uuid=row["uuid"],
        kind=row["kind"],
        name=row["name"],
        project=row["project"],
        status=row["status"],
        spec_data=json.loads(row["spec"]),
        group_id=row["group_id"],
        pipeline_id=row["pipeline_id"],
        original_id=row["original_id"],
        cloning_strategy=row["cloning_strategy"],
        restarts=row["restarts"],
        tags=json.loads(row["tags"]),
        last_metric=json.loads(row["last_metric"]),
        outputs_path=row["outputs_path"],
        code_ref=row["code_ref"],
        service_url=row["service_url"],
        meta=json.loads(row["meta"] or "{}"),
        created_at=row["created_at"],
        updated_at=row["updated_at"],
        started_at=row["started_at"],
        finished_at=row["finished_at"],
        archived_at=row["archived_at"],
    )


class _TimedLock:
    """``threading.Lock`` wrapper observing wait + hold time on a stats
    backend (``registry_lock_wait_s`` / ``registry_lock_hold_s``).

    Assigned to ``RunRegistry._lock`` so the ~60 ``with self._lock``
    write sites — and graft-lint GL003's lexical lock-discipline check —
    keep working unchanged.  With no stats attached the wrapper costs one
    attribute read per acquisition; ``_held_at`` is only touched by the
    holding thread, so it needs no extra synchronization.
    """

    __slots__ = ("_lock", "_owner", "_held_at")

    def __init__(self, owner: "RunRegistry") -> None:
        self._lock = threading.Lock()
        self._owner = owner
        self._held_at = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stats = self._owner._stats
        if stats is None:
            return self._lock.acquire(blocking, timeout)
        t0 = time.perf_counter()
        got = self._lock.acquire(blocking, timeout)
        if got:
            stats.observe("registry_lock_wait_s", time.perf_counter() - t0)
            self._held_at = time.perf_counter()
        return got

    def release(self) -> None:
        stats = self._owner._stats
        if stats is not None and self._held_at:
            stats.observe(
                "registry_lock_hold_s", time.perf_counter() - self._held_at
            )
            self._held_at = 0.0
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "_TimedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()


#: Operation families for ``registry_op_s{op=...}`` — a bounded label set
#: (GL007 checks label values stay bounded; raw method names would be ~100
#: series, these are 6).  Methods not named here classify by prefix.
_INGEST_OPS = frozenset({
    "add_metric", "add_log", "add_logs", "add_span", "add_utilization",
    "add_anomaly", "upsert_progress", "ping_heartbeat", "set_report_offset",
    "upsert_process", "upsert_capture", "record_activity",
    "add_metric_samples", "fold_metric_baseline",
})
_LIFECYCLE_OPS = frozenset({
    "create_run", "set_status", "update_run", "merge_run_meta",
    "archive_run", "restore_run", "delete_run",
})
_RETENTION_OPS = frozenset({
    "clean_old_rows", "expire_commands", "expire_remediations",
})
_READ_PREFIXES = (
    "get_", "list_", "last_", "count_", "has_", "project_", "free_",
    "queued_", "zombie_", "stale_", "archived_", "usage_", "advance_",
)


def _op_family(name: str) -> str:
    if name in _INGEST_OPS:
        return "ingest"
    if name in _LIFECYCLE_OPS:
        return "lifecycle"
    if name in _RETENTION_OPS:
        return "retention"
    if name in ("upsert_alert", "delete_alert"):
        return "alerts"
    if name.startswith(_READ_PREFIXES):
        return "read"
    return "write"


def _timed_op(name: str, fn: Any) -> Any:
    """Per-operation-family latency wrapper applied to every public
    ``RunRegistry`` method: with a stats backend attached each call lands
    in ``registry_op_s{op=<family>}``; without one the overhead is a
    single attribute check."""
    key = labeled_key("registry_op_s", op=_op_family(name))

    @functools.wraps(fn)
    def wrapper(self: "RunRegistry", *args: Any, **kwargs: Any) -> Any:
        stats = self._stats
        if stats is None:
            return fn(self, *args, **kwargs)
        t0 = time.perf_counter()
        try:
            return fn(self, *args, **kwargs)
        finally:
            stats.observe(key, time.perf_counter() - t0)

    wrapper.__wrapped_op__ = name
    return wrapper


class RunRegistry:
    """Sqlite-backed run registry, safe across threads and processes.

    Every status write passes the lifecycle gate; a rejected transition is
    reported (``False``) rather than raised, mirroring how the reference
    silently skips illegal writes after checking ``can_transition``.
    """

    #: Self-telemetry backend (None = uninstrumented).  A class attribute
    #: so the lock/op wrappers are safe during ``__init__`` too.
    _stats: Optional[Any] = None

    def __init__(self, path: Union[str, Path] = ":memory:") -> None:
        self.path = str(path)
        self._local = threading.local()
        self._lock = _TimedLock(self)
        with self._conn() as conn:
            conn.executescript(_SCHEMA)
            # In-place migration for registries created before the durable
            # report-offset column (CREATE IF NOT EXISTS won't add it).
            cols = {r[1] for r in conn.execute("PRAGMA table_info(processes)")}
            if "report_offset" not in cols:
                conn.execute(
                    "ALTER TABLE processes ADD COLUMN"
                    " report_offset INTEGER NOT NULL DEFAULT 0"
                )
            run_cols = {r[1] for r in conn.execute("PRAGMA table_info(runs)")}
            if "service_url" not in run_cols:
                conn.execute("ALTER TABLE runs ADD COLUMN service_url TEXT")
            proj_cols = {r[1] for r in conn.execute("PRAGMA table_info(projects)")}
            if "owner" not in proj_cols:
                # Pre-ownership projects stay ownerless (= open access).
                conn.execute("ALTER TABLE projects ADD COLUMN owner TEXT")
            user_cols = {r[1] for r in conn.execute("PRAGMA table_info(users)")}
            if "sso_provider" not in user_cols:
                # NULL = locally-created user; set = which SSO provider
                # owns this identity (no cross-takeover by name collision).
                conn.execute("ALTER TABLE users ADD COLUMN sso_provider TEXT")
            if "archived_at" not in run_cols:
                conn.execute("ALTER TABLE runs ADD COLUMN archived_at REAL")
            if "meta" not in run_cols:
                conn.execute(
                    "ALTER TABLE runs ADD COLUMN meta TEXT NOT NULL DEFAULT '{}'"
                )

    # -- connection management ------------------------------------------------
    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path, timeout=30.0, check_same_thread=False)
            conn.row_factory = sqlite3.Row
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA busy_timeout=30000")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None

    # -- self-telemetry --------------------------------------------------------
    def attach_stats(self, stats: Optional[Any]) -> None:
        """Turn on registry self-telemetry: per-operation-family latency
        (``registry_op_s{op=...}``) plus write-lock wait/hold histograms
        (``registry_lock_wait_s`` / ``registry_lock_hold_s``) on ``stats``.
        The orchestrator calls this once its stats backend exists (the
        registry is constructed first — it *stores* the config the stats
        backend choice reads from).  ``None`` detaches."""
        self._stats = stats

    # -- runs ----------------------------------------------------------------
    def create_run(
        self,
        spec: Union[BaseSpecification, Dict[str, Any]],
        *,
        name: Optional[str] = None,
        project: str = "default",
        group_id: Optional[int] = None,
        pipeline_id: Optional[int] = None,
        original_id: Optional[int] = None,
        cloning_strategy: Optional[str] = None,
        tags: Optional[Iterable[str]] = None,
        status: str = S.CREATED,
    ) -> Run:
        if isinstance(spec, BaseSpecification):
            spec_data = spec.stored_dict()
            kind = spec.kind
            name = name or spec.name
            spec_tags = spec.tags
        else:
            spec_data = dict(spec)
            kind = spec_data.get("kind")
            if kind is None:
                raise RegistryError("spec dict must carry a 'kind'")
            spec_tags = spec_data.get("tags", [])
        lifecycle = lifecycle_for_kind(kind)
        if not lifecycle.can_transition(None, status):
            raise RegistryError(f"Runs of kind {kind!r} cannot be born {status!r}")
        now = time.time()
        run_uuid = uuid_mod.uuid4().hex
        all_tags = sorted(set(spec_tags) | set(tags or ()))
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                """INSERT INTO runs (uuid, kind, name, project, spec, status,
                                     group_id, pipeline_id, original_id,
                                     cloning_strategy, tags, created_at, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
                (
                    run_uuid,
                    kind,
                    name,
                    project,
                    json.dumps(spec_data),
                    status,
                    group_id,
                    pipeline_id,
                    original_id,
                    cloning_strategy,
                    json.dumps(all_tags),
                    now,
                    now,
                ),
            )
            run_id = cur.lastrowid
            conn.execute(
                "INSERT INTO statuses (run_id, status, message, created_at) VALUES (?, ?, ?, ?)",
                (run_id, status, None, now),
            )
        return self.get_run(run_id)

    def get_run(self, run: Union[int, str]) -> Run:
        col = "uuid" if isinstance(run, str) else "id"
        row = self._conn().execute(f"SELECT * FROM runs WHERE {col} = ?", (run,)).fetchone()
        if row is None:
            raise RegistryError(f"No run with {col}={run!r}")
        return _row_to_run(row)

    def list_runs(
        self,
        *,
        kind: Optional[str] = None,
        project: Optional[str] = None,
        group_id: Optional[int] = None,
        pipeline_id: Optional[int] = None,
        statuses: Optional[Sequence[str]] = None,
        limit: Optional[int] = None,
        offset: int = 0,
        extra_where: Optional[Tuple[Sequence[str], Sequence[Any]]] = None,
        archived: Optional[bool] = None,
    ) -> List[Run]:
        """``extra_where`` is (clauses, params) compiled by the query DSL
        builder — pushed-down conditions on real columns (the reference
        compiles its DSL into queryset filters, ``query/builder.py:18-31``).

        ``archived`` mirrors the reference's default/archived model
        managers (its archives API lists them separately): False = live
        runs only, True = archived only, None = both.  The default is
        None — include everything — because the control plane itself
        (polyflow dag checks, hpsearch trial accounting, recovery) must
        see archived rows; USER listing surfaces (API/CLI) pass False."""
        clauses, params = [], []
        if archived is False:
            clauses.append("archived_at IS NULL")
        elif archived is True:
            clauses.append("archived_at IS NOT NULL")
        if extra_where is not None:
            clauses.extend(extra_where[0])
            params.extend(extra_where[1])
        if kind is not None:
            clauses.append("kind = ?")
            params.append(kind)
        if project is not None:
            clauses.append("project = ?")
            params.append(project)
        if group_id is not None:
            clauses.append("group_id = ?")
            params.append(group_id)
        if pipeline_id is not None:
            clauses.append("pipeline_id = ?")
            params.append(pipeline_id)
        if statuses:
            clauses.append(f"status IN ({','.join('?' * len(statuses))})")
            params.extend(statuses)
        where = f"WHERE {' AND '.join(clauses)}" if clauses else ""
        sql = f"SELECT * FROM runs {where} ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)} OFFSET {int(offset)}"
        rows = self._conn().execute(sql, params).fetchall()
        return [_row_to_run(r) for r in rows]

    def update_run(self, run_id: int, **fields: Any) -> None:
        allowed = {
            "name",
            "project",
            "outputs_path",
            "code_ref",
            "group_id",
            "pipeline_id",
            "original_id",
            "cloning_strategy",
            "restarts",
            "service_url",
        }
        unknown = set(fields) - allowed
        if unknown:
            raise RegistryError(f"Cannot update fields {sorted(unknown)}")
        if not fields:
            return
        sets = ", ".join(f"{k} = ?" for k in fields)
        with self._lock, self._conn() as conn:
            conn.execute(
                f"UPDATE runs SET {sets}, updated_at = ? WHERE id = ?",
                (*fields.values(), time.time(), run_id),
            )

    def merge_run_meta(self, run_id: int, **patch: Any) -> Dict[str, Any]:
        """Shallow-merge keys into the run's control-plane ``meta`` blob
        under the write lock (read-merge-write, so concurrent patches to
        different keys never clobber each other).  A key set to ``None``
        is removed.  Returns the merged blob."""
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute(
                "SELECT meta FROM runs WHERE id = ?", (run_id,)
            ).fetchone()
            if row is None:
                raise RegistryError(f"Run {run_id} does not exist")
            meta = json.loads(row["meta"] or "{}")
            for key, value in patch.items():
                if value is None:
                    meta.pop(key, None)
                else:
                    meta[key] = value
            conn.execute(
                "UPDATE runs SET meta = ?, updated_at = ? WHERE id = ?",
                (json.dumps(meta), time.time(), run_id),
            )
        return meta

    # -- archival + deletion ---------------------------------------------------
    # Parity: the reference's archived model managers + archives API
    # (``api/archives/``) and its archive-deletion beat pipeline
    # (``crons/tasks/deletion.py`` → ``scheduler/tasks/deletion.py``,
    # scheduled at ``config_settings/celery_settings.py:740-860``).  The
    # registry only flips rows; stopping gangs and GC-ing artifacts is the
    # orchestrator's job (it owns the spawner and the stores).

    def archive_run(self, run_id: int) -> bool:
        """Hide a run (and its children — a group's trials, a pipeline's
        ops) from user listings; returns False if already archived.
        Archived runs keep full history (statuses/metrics/logs) until the
        retention cron or an explicit delete purges them.  Cascading here
        keeps archive symmetric with delete_run's cascade: nothing can be
        purged by the parent's retention sweep while still presenting as
        a live run in the default view."""
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            family = self._family_fixpoint(run_id)
            marks = ",".join("?" * len(family))
            cur = conn.execute(
                f"UPDATE runs SET archived_at = ?, updated_at = ?"
                f" WHERE id IN ({marks}) AND archived_at IS NULL",
                (now, now, *family),
            )
        return cur.rowcount > 0

    def restore_run(self, run_id: int) -> bool:
        """Un-archive a run and its children (the reference archives
        API's restore endpoints)."""
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            family = self._family_fixpoint(run_id)
            marks = ",".join("?" * len(family))
            cur = conn.execute(
                f"UPDATE runs SET archived_at = NULL, updated_at = ?"
                f" WHERE id IN ({marks}) AND archived_at IS NOT NULL",
                (time.time(), *family),
            )
        return cur.rowcount > 0

    def _family_ids(self, run_id: int) -> List[int]:
        """``run_id`` plus every transitive child (trials via group_id,
        pipeline ops via pipeline_id).  Raises if the root is missing."""
        if not self._run_exists(run_id):
            raise RegistryError(f"No run with id={run_id}")
        out: List[int] = []
        frontier = [run_id]
        seen = set()
        while frontier:
            rid = frontier.pop()
            if rid in seen:
                continue
            seen.add(rid)
            out.append(rid)
            for child in self._conn().execute(
                "SELECT id FROM runs WHERE group_id = ? OR pipeline_id = ?",
                (rid, rid),
            ):
                frontier.append(child["id"])
        return out

    def _family_fixpoint(self, run_id: int) -> List[int]:
        """Family walk re-run until STABLE — called with the write lock
        held (``_lock`` + ``BEGIN IMMEDIATE``), so trial/pipeline children
        created concurrently with an archive/restore/delete cannot land
        between the walk and the mutation and escape the cascade.  The
        re-walk catches children inserted during the first traversal."""
        family = self._family_ids(run_id)
        while True:
            seen = set(family)
            fresh = [i for i in self._family_ids(run_id) if i not in seen]
            if not fresh:
                return family
            family += fresh

    def _run_exists(self, run_id: int) -> bool:
        return (
            self._conn()
            .execute("SELECT 1 FROM runs WHERE id = ?", (run_id,))
            .fetchone()
            is not None
        )

    def delete_run(self, run_id: int) -> List[Run]:
        """Purge a run and every row that references it, CASCADING to its
        children (a group's trials, a pipeline's operations — the reference
        gets this from FK on_delete cascades).  Returns the deleted Run
        records (pre-delete snapshots) so the caller can GC outputs dirs
        and store artifacts — the registry never touches the filesystem."""
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            victims = [self.get_run(rid) for rid in self._family_fixpoint(run_id)]
            ids = [r.id for r in victims]
            marks = ",".join("?" * len(ids))
            # Free any held slices before the claim rows go away.
            conn.execute(
                f"UPDATE devices SET run_id = NULL, updated_at = ?"
                f" WHERE run_id IN ({marks})",
                (time.time(), *ids),
            )
            for table, col in (
                ("device_claims", "run_id"),
                ("statuses", "run_id"),
                ("metrics", "run_id"),
                ("logs", "run_id"),
                ("spans", "run_id"),
                ("progress", "run_id"),
                ("anomalies", "run_id"),
                ("utilization", "run_id"),
                ("metric_samples", "run_id"),
                ("commands", "run_id"),
                ("captures", "run_id"),
                ("alerts", "run_id"),
                ("remediations", "run_id"),
                ("heartbeats", "run_id"),
                ("processes", "run_id"),
                ("bookmarks", "run_id"),
                ("chart_views", "run_id"),
                ("iterations", "group_id"),
                ("runs", "id"),
            ):
                conn.execute(
                    f"DELETE FROM {table} WHERE {col} IN ({marks})", ids
                )
        return victims

    def archived_runs_older_than(
        self, seconds: float, now: Optional[float] = None
    ) -> List[Run]:
        """Archived runs past the retention horizon — the purge cron's
        worklist (reference ``CLEANING_INTERVALS_ARCHIVES`` date check).
        Children of an archived group/pipeline are purged with their
        parent via delete_run's cascade, so only top-level rows return."""
        cutoff = (now or time.time()) - seconds
        rows = self._conn().execute(
            "SELECT * FROM runs WHERE archived_at IS NOT NULL AND archived_at < ?"
            " ORDER BY id",
            (cutoff,),
        ).fetchall()
        return [_row_to_run(r) for r in rows]

    # -- statuses -------------------------------------------------------------
    def set_status(
        self,
        run_id: int,
        status: str,
        message: Optional[str] = None,
    ) -> bool:
        """Gated status write; returns whether the transition was applied."""
        now = time.time()
        with self._lock, self._conn() as conn:
            # The lifecycle gate is check-then-act: take the write lock up
            # front so concurrent *processes* (the in-process lock can't see
            # them) serialize the whole read-check-write.
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute(
                "SELECT kind, status, started_at FROM runs WHERE id = ?", (run_id,)
            ).fetchone()
            if row is None:
                raise RegistryError(f"No run with id={run_id}")
            lifecycle = lifecycle_for_kind(row["kind"])
            if not lifecycle.can_transition(row["status"], status):
                return False
            started_at = row["started_at"]
            # Strictly the running phase: QUEUED/BUILDING time is waiting
            # (admission, snapshots), not runtime.
            if started_at is None and status in lifecycle.RUNNING_STATUS:
                started_at = now
            finished_at = now if lifecycle.is_done(status) else None
            conn.execute(
                """UPDATE runs SET status = ?, updated_at = ?, started_at = ?,
                                   finished_at = COALESCE(?, finished_at)
                   WHERE id = ?""",
                (status, now, started_at, finished_at, run_id),
            )
            conn.execute(
                "INSERT INTO statuses (run_id, status, message, created_at) VALUES (?, ?, ?, ?)",
                (run_id, status, message, now),
            )
        return True

    def get_statuses(self, run_id: int) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT status, message, created_at FROM statuses WHERE run_id = ? ORDER BY id",
            (run_id,),
        ).fetchall()
        return [dict(r) for r in rows]

    def count_by_status(
        self, *, kind: Optional[str] = None, group_id: Optional[int] = None
    ) -> Dict[str, int]:
        clauses, params = [], []
        if kind is not None:
            clauses.append("kind = ?")
            params.append(kind)
        if group_id is not None:
            clauses.append("group_id = ?")
            params.append(group_id)
        where = f"WHERE {' AND '.join(clauses)}" if clauses else ""
        rows = self._conn().execute(
            f"SELECT status, COUNT(*) AS n FROM runs {where} GROUP BY status", params
        ).fetchall()
        return {r["status"]: r["n"] for r in rows}

    # -- metrics --------------------------------------------------------------
    def add_metric(
        self, run_id: int, values: Dict[str, Any], step: Optional[int] = None
    ) -> None:
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute(
                "SELECT last_metric FROM runs WHERE id = ?", (run_id,)
            ).fetchone()
            if row is None:
                raise RegistryError(f"No run with id={run_id}")
            merged = json.loads(row["last_metric"])
            merged.update(values)
            conn.execute(
                "INSERT INTO metrics (run_id, step, vals, created_at) VALUES (?, ?, ?, ?)",
                (run_id, step, json.dumps(values), now),
            )
            conn.execute(
                "UPDATE runs SET last_metric = ?, updated_at = ? WHERE id = ?",
                (json.dumps(merged), now, run_id),
            )

    def get_metrics(self, run_id: int, since_id: int = 0) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT id, step, vals, created_at FROM metrics WHERE run_id = ? AND id > ? ORDER BY id",
            (run_id, since_id),
        ).fetchall()
        return [
            {
                "id": r["id"],
                "step": r["step"],
                "values": json.loads(r["vals"]),
                "created_at": r["created_at"],
            }
            for r in rows
        ]

    def last_metric(self, run_id: int) -> Dict[str, Any]:
        return self.get_run(run_id).last_metric

    # -- logs -----------------------------------------------------------------
    def add_log(
        self,
        run_id: int,
        line: str,
        process_id: Optional[int] = None,
        created_at: Optional[float] = None,
    ) -> None:
        with self._lock, self._conn() as conn:
            conn.execute(
                "INSERT INTO logs (run_id, process_id, line, created_at) VALUES (?, ?, ?, ?)",
                (run_id, process_id, line, created_at or time.time()),
            )

    def add_logs(
        self, run_id: int, lines: Iterable[Tuple[Optional[int], str]]
    ) -> None:
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.executemany(
                "INSERT INTO logs (run_id, process_id, line, created_at) VALUES (?, ?, ?, ?)",
                [(run_id, pid, line, now) for pid, line in lines],
            )

    def get_logs(
        self,
        run_id: int,
        *,
        process_id: Optional[int] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        sql = "SELECT id, process_id, line, created_at FROM logs WHERE run_id = ? AND id > ?"
        params: List[Any] = [run_id, since_id]
        if process_id is not None:
            sql += " AND process_id = ?"
            params.append(process_id)
        sql += " ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        return [dict(r) for r in rows]

    # -- spans ----------------------------------------------------------------
    def add_span(
        self,
        run_id: int,
        span: Dict[str, Any],
        process_id: Optional[int] = None,
    ) -> None:
        """Store one finished tracer span (a ``span`` report event).

        ``span`` is the record shape tracking/trace.py emits — unknown
        keys are folded into ``attrs`` so the channel can grow fields
        without a schema change."""
        known = {
            "name",
            "trace_id",
            "span_id",
            "parent_id",
            "thread",
            "start",
            "duration",
            "process_id",
            "attrs",
        }
        attrs = dict(span.get("attrs") or {})
        for key, value in span.items():
            if key not in known and key not in ("type", "ts"):
                attrs[key] = value
        if process_id is None:
            process_id = span.get("process_id")
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO spans
                   (run_id, process_id, trace_id, span_id, parent_id, name,
                    thread, start, duration, attrs, created_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
                (
                    run_id,
                    process_id,
                    span.get("trace_id"),
                    span.get("span_id"),
                    span.get("parent_id"),
                    str(span.get("name") or "span"),
                    span.get("thread"),
                    float(span.get("start") or 0.0),
                    float(span.get("duration") or 0.0),
                    json.dumps(attrs) if attrs else None,
                    time.time(),
                ),
            )

    def get_spans(
        self,
        run_id: int,
        *,
        process_id: Optional[int] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Spans for a run ordered by wall-clock start (timeline order)."""
        sql = (
            "SELECT id, process_id, trace_id, span_id, parent_id, name,"
            " thread, start, duration, attrs, created_at"
            " FROM spans WHERE run_id = ? AND id > ?"
        )
        params: List[Any] = [run_id, since_id]
        if process_id is not None:
            sql += " AND process_id = ?"
            params.append(process_id)
        sql += " ORDER BY start, id"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        out: List[Dict[str, Any]] = []
        for r in rows:
            span = dict(r)
            span["attrs"] = json.loads(span["attrs"]) if span["attrs"] else {}
            out.append(span)
        return out

    # -- utilization ledger ----------------------------------------------------
    def add_utilization(
        self,
        run_id: int,
        row: Dict[str, Any],
        process_id: Optional[int] = None,
    ) -> None:
        """Store one utilization-ledger row (a ``ledger`` report event).

        ``row`` is the record shape tracking/ledger.py emits — unknown
        keys are folded into ``attrs`` so the channel can grow fields
        without a schema change."""
        known = {
            "seq",
            "source",
            "wall_s",
            "buckets",
            "steps",
            "tokens",
            "flops",
            "goodput",
            "mfu",
            "tokens_per_device_s",
            "compile_s",
            "compile_events",
            "hbm_peak_bytes",
            "devices",
            "device_kind",
            "peak_flops_per_s",
            "final",
            "process_id",
            "attrs",
        }
        attrs = dict(row.get("attrs") or {})
        for key, value in row.items():
            if key not in known and key not in ("type", "ts"):
                attrs[key] = value
        if process_id is None:
            process_id = row.get("process_id")
        buckets = row.get("buckets") or {}
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO utilization
                   (run_id, process_id, seq, source, wall_s, buckets, steps,
                    tokens, flops, goodput, mfu, tokens_per_device_s,
                    compile_s, compile_events, hbm_peak_bytes, devices,
                    device_kind, peak_flops_per_s, final, attrs, created_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
                (
                    run_id,
                    process_id,
                    int(row.get("seq") or 0),
                    str(row.get("source") or "train"),
                    float(row.get("wall_s") or 0.0),
                    json.dumps(buckets) if buckets else None,
                    int(row.get("steps") or 0),
                    int(row.get("tokens") or 0),
                    float(row.get("flops") or 0.0),
                    float(row.get("goodput") or 0.0),
                    float(row.get("mfu") or 0.0),
                    float(row.get("tokens_per_device_s") or 0.0),
                    float(row.get("compile_s") or 0.0),
                    int(row.get("compile_events") or 0),
                    float(row.get("hbm_peak_bytes") or 0.0),
                    int(row.get("devices") or 0),
                    str(row.get("device_kind") or ""),
                    float(row.get("peak_flops_per_s") or 0.0),
                    1 if row.get("final") else 0,
                    json.dumps(attrs) if attrs else None,
                    float(row.get("ts") or time.time()),
                ),
            )

    def get_utilization(
        self,
        run_id: int,
        *,
        process_id: Optional[int] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Ledger rows for a run in ingest order (rows are cumulative per
        process — the latest per process_id is its current truth)."""
        sql = (
            "SELECT id, process_id, seq, source, wall_s, buckets, steps,"
            " tokens, flops, goodput, mfu, tokens_per_device_s, compile_s,"
            " compile_events, hbm_peak_bytes, devices, device_kind,"
            " peak_flops_per_s, final, attrs, created_at"
            " FROM utilization WHERE run_id = ? AND id > ?"
        )
        params: List[Any] = [run_id, since_id]
        if process_id is not None:
            sql += " AND process_id = ?"
            params.append(process_id)
        sql += " ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        out: List[Dict[str, Any]] = []
        for r in rows:
            rec = dict(r)
            rec["buckets"] = json.loads(rec["buckets"]) if rec["buckets"] else {}
            rec["attrs"] = json.loads(rec["attrs"]) if rec["attrs"] else {}
            rec["final"] = bool(rec["final"])
            out.append(rec)
        return out

    # -- metric history (TSDB write-behind) ------------------------------------
    def add_metric_samples(self, rows: Sequence[Dict[str, Any]]) -> int:
        """Batched ingest for the scrape phase's write-behind: one
        executemany per flush, not one transaction per sample.  A
        ``run="<id>"`` label on the series name is denormalized into the
        ``run_id`` column so delete_run's cascade and the per-run history
        API stay indexed."""
        if not rows:
            return 0
        now = time.time()
        params: List[Tuple[Any, ...]] = []
        for row in rows:
            name = row.get("name")
            if not name:
                continue
            run_id: Optional[int] = row.get("run_id")
            if run_id is None and 'run="' in name:
                _base, labels = split_labeled_key(name)
                raw = labels.get("run")
                if raw is not None:
                    try:
                        run_id = int(raw)
                    except ValueError:
                        run_id = None
            at = row.get("at")
            params.append((
                str(name),
                run_id,
                float(at) if at is not None else now,
                float(row.get("value") or 0.0),
                str(row.get("agg") or "raw"),
                row.get("vmin"),
                row.get("vmax"),
                row.get("vsum"),
                row.get("vcount"),
                now,
            ))
        if not params:
            return 0
        with self._lock, self._conn() as conn:
            conn.executemany(
                """INSERT INTO metric_samples
                   (name, run_id, at, value, agg, vmin, vmax, vsum, vcount,
                    created_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
                params,
            )
        return len(params)

    def get_metric_samples(
        self,
        *,
        name: Optional[str] = None,
        run_id: Optional[int] = None,
        agg: Optional[str] = "raw",
        since: Optional[float] = None,
        until: Optional[float] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Persisted samples in id order (``since_id`` makes it a WS-tail
        cursor).  ``name`` matches the full labeled key exactly, or every
        label set of a base name when given without braces."""
        sql = (
            "SELECT id, name, run_id, at, value, agg, vmin, vmax, vsum,"
            " vcount, created_at FROM metric_samples WHERE id > ?"
        )
        params: List[Any] = [since_id]
        if name is not None:
            if "{" in name:
                sql += " AND name = ?"
                params.append(name)
            else:
                sql += " AND (name = ? OR name LIKE ?)"
                params.extend([name, name + "{%"])
        if run_id is not None:
            sql += " AND run_id = ?"
            params.append(run_id)
        if agg is not None:
            sql += " AND agg = ?"
            params.append(agg)
        if since is not None:
            sql += " AND at >= ?"
            params.append(float(since))
        if until is not None:
            sql += " AND at <= ?"
            params.append(float(until))
        sql += " ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        return [dict(r) for r in rows]

    def fold_metric_baseline(
        self,
        project: str,
        kind: str,
        series: str,
        value: float,
        *,
        alpha: float = 0.3,
        run_id: Optional[int] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Fold one completed-run summary value into its (project, kind,
        series) baseline row — exponentially weighted mean + variance, so
        a drifting fleet tracks and a noisy series widens its own band.
        Returns the *prior* mean/std/count alongside the new ones: the
        regression comparator judges the run against the baseline as it
        stood before this run was folded in.
        """
        now = now or time.time()
        alpha = min(1.0, max(0.0, float(alpha)))
        value = float(value)
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute(
                "SELECT ewma, ewvar, count FROM metric_baselines"
                " WHERE project = ? AND kind = ? AND series = ?",
                (project, kind, series),
            ).fetchone()
            if row is None:
                prior_mean = prior_var = None
                prior_count = 0
                mean, var, count = value, 0.0, 1
            else:
                prior_mean = float(row["ewma"])
                prior_var = float(row["ewvar"])
                prior_count = int(row["count"])
                # West (1979) EW update: variance first (it uses the old
                # mean), then the mean.
                diff = value - prior_mean
                var = (1.0 - alpha) * (prior_var + alpha * diff * diff)
                mean = prior_mean + alpha * diff
                count = prior_count + 1
            conn.execute(
                """INSERT INTO metric_baselines
                   (project, kind, series, ewma, ewvar, count, last_value,
                    last_run_id, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)
                   ON CONFLICT (project, kind, series) DO UPDATE SET
                     ewma = excluded.ewma, ewvar = excluded.ewvar,
                     count = excluded.count, last_value = excluded.last_value,
                     last_run_id = excluded.last_run_id,
                     updated_at = excluded.updated_at""",
                (project, kind, series, mean, var, count, value, run_id, now),
            )
        return {
            "project": project,
            "kind": kind,
            "series": series,
            "value": value,
            "prior_mean": prior_mean,
            "prior_std": math.sqrt(prior_var) if prior_var is not None else None,
            "prior_count": prior_count,
            "mean": mean,
            "std": math.sqrt(var),
            "count": count,
        }

    def get_metric_baselines(
        self, project: str, kind: Optional[str] = None
    ) -> List[Dict[str, Any]]:
        sql = (
            "SELECT project, kind, series, ewma, ewvar, count, last_value,"
            " last_run_id, updated_at FROM metric_baselines WHERE project = ?"
        )
        params: List[Any] = [project]
        if kind is not None:
            sql += " AND kind = ?"
            params.append(kind)
        sql += " ORDER BY kind, series"
        rows = self._conn().execute(sql, params).fetchall()
        out = []
        for r in rows:
            rec = dict(r)
            rec["std"] = math.sqrt(max(0.0, rec.pop("ewvar")))
            rec["mean"] = rec.pop("ewma")
            out.append(rec)
        return out

    # -- heartbeats -----------------------------------------------------------
    def ping_heartbeat(self, run_id: int, at: Optional[float] = None) -> None:
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO heartbeats (run_id, last_at) VALUES (?, ?)
                   ON CONFLICT (run_id) DO UPDATE SET last_at = excluded.last_at""",
                (run_id, at or time.time()),
            )

    def last_heartbeat(self, run_id: int) -> Optional[float]:
        row = self._conn().execute(
            "SELECT last_at FROM heartbeats WHERE run_id = ?", (run_id,)
        ).fetchone()
        return row["last_at"] if row else None

    def zombie_runs(self, ttl_seconds: float, now: Optional[float] = None) -> List[Run]:
        """Runs in a heartbeat-requiring status whose heartbeat is stale.

        Parity: the reference's zombie cron
        (``crons/tasks/heartbeats.py`` + ``scheduler/tasks/experiments.py:111-120``).
        """
        now = now or time.time()
        # One indexed scan over live statuses; the per-lifecycle predicate is
        # re-checked on the (small) candidate set.
        rows = self._conn().execute(
            """SELECT r.* FROM runs r LEFT JOIN heartbeats h ON h.run_id = r.id
               WHERE r.status = ? AND (h.last_at IS NULL OR ? - h.last_at > ?)""",
            (S.RUNNING, now, ttl_seconds),
        ).fetchall()
        return [
            run
            for run in map(_row_to_run, rows)
            if run.lifecycle.needs_heartbeat(run.status)
        ]

    # -- progress + anomalies --------------------------------------------------
    def upsert_progress(
        self,
        run_id: int,
        process_id: int,
        *,
        step: Optional[int] = None,
        epoch: Optional[int] = None,
        throughput: Optional[float] = None,
        at: Optional[float] = None,
    ) -> None:
        """Latest-wins forward-progress marker per gang process.

        One row per (run, process): the stall/straggler detector only ever
        needs the newest beat, and metric rows already carry history —
        keeping this a fixed-size upsert means the detector's poll is O(gang)
        no matter how long the run is."""
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO progress
                   (run_id, process_id, step, epoch, throughput, at, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?)
                   ON CONFLICT (run_id, process_id) DO UPDATE SET
                     step = COALESCE(excluded.step, step),
                     epoch = COALESCE(excluded.epoch, epoch),
                     throughput = COALESCE(excluded.throughput, throughput),
                     at = excluded.at,
                     updated_at = excluded.updated_at""",
                (run_id, process_id, step, epoch, throughput,
                 at or time.time(), time.time()),
            )

    def get_progress(self, run_id: int) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT process_id, step, epoch, throughput, at, updated_at"
            " FROM progress WHERE run_id = ? ORDER BY process_id",
            (run_id,),
        ).fetchall()
        return [dict(r) for r in rows]

    def add_anomaly(
        self,
        run_id: int,
        kind: str,
        *,
        process_id: Optional[int] = None,
        message: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
        created_at: Optional[float] = None,
    ) -> None:
        """One detected anomaly (stall/straggler/crash) — append-only, like
        statuses: the rows ARE the incident timeline."""
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO anomalies
                   (run_id, process_id, kind, message, attrs, created_at)
                   VALUES (?, ?, ?, ?, ?, ?)""",
                (
                    run_id,
                    process_id,
                    str(kind),
                    message,
                    json.dumps(attrs, default=str) if attrs else None,
                    created_at or time.time(),
                ),
            )

    def get_anomalies(
        self,
        run_id: int,
        *,
        kind: Optional[str] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        sql = (
            "SELECT id, process_id, kind, message, attrs, created_at"
            " FROM anomalies WHERE run_id = ? AND id > ?"
        )
        params: List[Any] = [run_id, since_id]
        if kind is not None:
            sql += " AND kind = ?"
            params.append(kind)
        sql += " ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        out: List[Dict[str, Any]] = []
        for r in rows:
            row = dict(r)
            row["attrs"] = json.loads(row["attrs"]) if row["attrs"] else {}
            out.append(row)
        return out

    # -- commands (control plane → worker bus) --------------------------------
    def enqueue_command(
        self,
        run_id: int,
        kind: str,
        *,
        payload: Optional[Dict[str, Any]] = None,
        process_id: Optional[int] = None,
        expected: int = 1,
        uuid: Optional[str] = None,
        status: str = CommandStatus.PENDING,
        message: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Record a worker-directed command (the durable side of the bus;
        delivery is the per-process mailbox the spawner provisions).
        ``expected`` is how many processes must report a terminal state
        before the roll-up resolves; ``process_id`` pins single-host
        commands (None = whole gang)."""
        import uuid as uuid_mod

        cmd_uuid = uuid or uuid_mod.uuid4().hex
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO commands
                   (run_id, uuid, kind, process_id, payload, status, message,
                    acks, expected, created_at, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, '{}', ?, ?, ?)""",
                (
                    run_id,
                    cmd_uuid,
                    str(kind),
                    process_id,
                    json.dumps(payload or {}, default=str),
                    status,
                    message,
                    int(expected),
                    now,
                    now,
                ),
            )
        return self.get_command(cmd_uuid)

    def get_command(self, uuid: str) -> Optional[Dict[str, Any]]:
        row = self._conn().execute(
            "SELECT * FROM commands WHERE uuid = ?", (uuid,)
        ).fetchone()
        return self._command_row(row) if row is not None else None

    def get_commands(
        self,
        run_id: int,
        *,
        kind: Optional[str] = None,
        status: Optional[str] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        sql = "SELECT * FROM commands WHERE run_id = ? AND id > ?"
        params: List[Any] = [run_id, since_id]
        if kind is not None:
            sql += " AND kind = ?"
            params.append(kind)
        if status is not None:
            sql += " AND status = ?"
            params.append(status)
        sql += " ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        return [self._command_row(r) for r in rows]

    @staticmethod
    def _command_row(row: sqlite3.Row) -> Dict[str, Any]:
        out = dict(row)
        out["payload"] = json.loads(out["payload"]) if out["payload"] else {}
        out["acks"] = json.loads(out["acks"]) if out["acks"] else {}
        return out

    def mark_command(
        self,
        uuid: str,
        process_id: int,
        state: str,
        *,
        message: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Fold one process's command state into the row and recompute the
        gang roll-up.  Per-process states are acked/complete/failed; the
        roll-up goes COMPLETE once ``expected`` processes are terminal and
        none failed, FAILED if any did.  A command the control plane
        already resolved (EXPIRED) never un-resolves — late worker lines
        land in ``acks`` for forensics but don't flip the status.

        ``attrs`` carries handler result data (e.g. checkpoint-now's saved
        step) — the ack value then becomes ``{"state":..., "attrs":...}``;
        attr-less acks stay plain strings for compatibility."""
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute(
                "SELECT * FROM commands WHERE uuid = ?", (uuid,)
            ).fetchone()
            if row is None:
                return None
            acks = json.loads(row["acks"]) if row["acks"] else {}
            acks[str(int(process_id))] = (
                {"state": state, "attrs": attrs} if attrs else state
            )
            status = row["status"]
            if status not in CommandStatus.TERMINAL:
                terminal = [
                    s
                    for s in (command_ack_state(v) for v in acks.values())
                    if s in (CommandStatus.COMPLETE, CommandStatus.FAILED)
                ]
                if len(terminal) >= max(1, row["expected"]):
                    status = (
                        CommandStatus.FAILED
                        if CommandStatus.FAILED in terminal
                        else CommandStatus.COMPLETE
                    )
                elif acks:
                    status = CommandStatus.ACKED
            conn.execute(
                """UPDATE commands SET acks = ?, status = ?, updated_at = ?,
                                       message = COALESCE(?, message)
                   WHERE uuid = ?""",
                (json.dumps(acks), status, time.time(), message, uuid),
            )
        return self.get_command(uuid)

    def expire_commands(
        self, run_id: int, *, message: str = "run finished before the gang honored the command"
    ) -> int:
        """Resolve every still-open command on a run to EXPIRED — called
        when the run goes terminal so a command never hangs un-answered."""
        placeholders = ",".join("?" * len(CommandStatus.TERMINAL))
        with self._lock, self._conn() as conn:
            return conn.execute(
                f"""UPDATE commands SET status = ?, message = ?, updated_at = ?
                    WHERE run_id = ? AND status NOT IN ({placeholders})""",
                (
                    CommandStatus.EXPIRED,
                    message,
                    time.time(),
                    run_id,
                    *CommandStatus.TERMINAL,
                ),
            ).rowcount

    # -- remediations (alert-driven actions) ----------------------------------
    @staticmethod
    def _remediation_row(row: sqlite3.Row) -> Dict[str, Any]:
        out = dict(row)
        out["attrs"] = json.loads(out["attrs"]) if out["attrs"] else {}
        return out

    def add_remediation(
        self,
        run_id: int,
        action: str,
        *,
        trigger: Optional[str] = None,
        status: str = RemediationStatus.PENDING,
        message: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Record one remediation action on a run's timeline."""
        now = time.time()
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                """INSERT INTO remediations
                       (run_id, action, trigger, status, message, attrs,
                        created_at, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?)""",
                (
                    run_id,
                    action,
                    trigger,
                    status,
                    message,
                    json.dumps(attrs) if attrs else None,
                    now,
                    now,
                ),
            )
            rem_id = cur.lastrowid
        return self.get_remediation(rem_id)

    def update_remediation(
        self,
        rem_id: int,
        *,
        status: Optional[str] = None,
        message: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> Optional[Dict[str, Any]]:
        """Advance a remediation row; ``attrs`` shallow-merge into the
        stored blob so phases can accrete result data."""
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute(
                "SELECT * FROM remediations WHERE id = ?", (rem_id,)
            ).fetchone()
            if row is None:
                return None
            merged = json.loads(row["attrs"]) if row["attrs"] else {}
            if attrs:
                merged.update(attrs)
            conn.execute(
                """UPDATE remediations
                   SET status = COALESCE(?, status),
                       message = COALESCE(?, message),
                       attrs = ?, updated_at = ?
                   WHERE id = ?""",
                (
                    status,
                    message,
                    json.dumps(merged) if merged else None,
                    time.time(),
                    rem_id,
                ),
            )
        return self.get_remediation(rem_id)

    def get_remediation(self, rem_id: int) -> Optional[Dict[str, Any]]:
        with self._lock, self._conn() as conn:
            row = conn.execute(
                "SELECT * FROM remediations WHERE id = ?", (rem_id,)
            ).fetchone()
        return self._remediation_row(row) if row else None

    def get_remediations(
        self,
        run_id: int,
        *,
        action: Optional[str] = None,
        status: Optional[str] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        query = "SELECT * FROM remediations WHERE run_id = ? AND id > ?"
        params: List[Any] = [run_id, since_id]
        if action is not None:
            query += " AND action = ?"
            params.append(action)
        if status is not None:
            query += " AND status = ?"
            params.append(status)
        query += " ORDER BY id"
        if limit is not None:
            query += " LIMIT ?"
            params.append(int(limit))
        with self._lock, self._conn() as conn:
            rows = conn.execute(query, params).fetchall()
        return [self._remediation_row(r) for r in rows]

    def count_remediations(
        self, run_id: int, *, statuses: Optional[Sequence[str]] = None
    ) -> int:
        """How many remediation actions a run has consumed — the budget
        check.  ``statuses`` narrows the count (e.g. exclude SKIPPED so
        recording a refusal doesn't itself consume budget)."""
        query = "SELECT COUNT(*) FROM remediations WHERE run_id = ?"
        params: List[Any] = [run_id]
        if statuses:
            query += f" AND status IN ({','.join('?' * len(statuses))})"
            params.extend(statuses)
        with self._lock, self._conn() as conn:
            return int(conn.execute(query, params).fetchone()[0])

    def expire_remediations(
        self,
        run_id: int,
        *,
        message: str = "run finished before the action resolved",
    ) -> int:
        """Close every still-open remediation row when a run goes
        terminal — mirrors ``expire_commands`` so nothing hangs open."""
        placeholders = ",".join("?" * len(RemediationStatus.OPEN))
        with self._lock, self._conn() as conn:
            return conn.execute(
                f"""UPDATE remediations SET status = ?, message = ?, updated_at = ?
                    WHERE run_id = ? AND status IN ({placeholders})""",
                (
                    RemediationStatus.EXPIRED,
                    message,
                    time.time(),
                    run_id,
                    *RemediationStatus.OPEN,
                ),
            ).rowcount

    # -- captures (on-demand profiling results) -------------------------------
    def upsert_capture(
        self,
        run_id: int,
        capture_id: str,
        process_id: int,
        *,
        status: Optional[str] = None,
        start_step: Optional[int] = None,
        num_steps: Optional[int] = None,
        started_at: Optional[float] = None,
        finished_at: Optional[float] = None,
        artifacts: Optional[List[str]] = None,
        message: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Latest-wins per-(run, capture, process) profiling record — the
        watcher folds workers' typed ``capture`` report lines here, so a
        capture's lifecycle (started → complete/failed) is one row per
        host, like ``progress``."""
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO captures
                   (run_id, capture_id, process_id, status, start_step,
                    num_steps, started_at, finished_at, artifacts, message,
                    attrs, created_at, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)
                   ON CONFLICT (run_id, capture_id, process_id) DO UPDATE SET
                     status = COALESCE(excluded.status, status),
                     start_step = COALESCE(excluded.start_step, start_step),
                     num_steps = COALESCE(excluded.num_steps, num_steps),
                     started_at = COALESCE(excluded.started_at, started_at),
                     finished_at = COALESCE(excluded.finished_at, finished_at),
                     artifacts = CASE WHEN excluded.artifacts != '[]'
                                      THEN excluded.artifacts ELSE artifacts END,
                     message = COALESCE(excluded.message, message),
                     attrs = COALESCE(excluded.attrs, attrs),
                     updated_at = excluded.updated_at""",
                (
                    run_id,
                    str(capture_id),
                    int(process_id),
                    status,
                    start_step,
                    num_steps,
                    started_at,
                    finished_at,
                    json.dumps(artifacts or [], default=str),
                    message,
                    json.dumps(attrs, default=str) if attrs else None,
                    now,
                    now,
                ),
            )

    def get_captures(
        self,
        run_id: int,
        *,
        capture_id: Optional[str] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        sql = "SELECT * FROM captures WHERE run_id = ? AND id > ?"
        params: List[Any] = [run_id, since_id]
        if capture_id is not None:
            sql += " AND capture_id = ?"
            params.append(capture_id)
        sql += " ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        out: List[Dict[str, Any]] = []
        for r in rows:
            row = dict(r)
            row["artifacts"] = json.loads(row["artifacts"]) if row["artifacts"] else []
            row["attrs"] = json.loads(row["attrs"]) if row["attrs"] else {}
            out.append(row)
        return out

    # -- alerts (rule-engine lifecycle rows) -----------------------------------
    def upsert_alert(
        self,
        run_id: int,
        rule: str,
        *,
        state: str,
        severity: str,
        message: Optional[str] = None,
        value: Optional[float] = None,
        for_s: Optional[float] = None,
        episodes: Optional[int] = None,
        pending_since: Optional[float] = None,
        fired_at: Optional[float] = None,
        resolved_at: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
        now: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Latest-state-per-(run, rule) alert row, like ``captures`` — but
        each transition REPLACEs the row so it gets a fresh autoincrement
        id: the feed stays one-row-per-alert while since_id pagers and the
        WS tail still observe every lifecycle edge.  ``pending_since`` /
        ``fired_at`` / ``episodes`` carry forward from the previous row
        when not supplied, so a resolve keeps its firing timestamp (that
        difference IS the alert latency bench reads)."""
        now = now or time.time()
        with self._lock, self._conn() as conn:
            prev = conn.execute(
                "SELECT * FROM alerts WHERE run_id = ? AND rule = ?",
                (run_id, str(rule)),
            ).fetchone()
            created_at = prev["created_at"] if prev else now
            if episodes is None:
                episodes = prev["episodes"] if prev else 0
            if pending_since is None and prev is not None:
                pending_since = prev["pending_since"]
            if fired_at is None and prev is not None:
                fired_at = prev["fired_at"]
            cur = conn.execute(
                """INSERT OR REPLACE INTO alerts
                   (run_id, rule, state, severity, message, value, for_s,
                    episodes, pending_since, fired_at, resolved_at, attrs,
                    created_at, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)""",
                (
                    run_id,
                    str(rule),
                    str(state),
                    str(severity),
                    message,
                    value,
                    for_s,
                    int(episodes),
                    pending_since,
                    fired_at,
                    resolved_at,
                    json.dumps(attrs, default=str) if attrs else None,
                    created_at,
                    now,
                ),
            )
            row_id = cur.lastrowid
        return {
            "id": row_id,
            "run_id": run_id,
            "rule": str(rule),
            "state": str(state),
            "severity": str(severity),
            "message": message,
            "value": value,
            "for_s": for_s,
            "episodes": int(episodes),
            "pending_since": pending_since,
            "fired_at": fired_at,
            "resolved_at": resolved_at,
            "attrs": attrs or {},
            "created_at": created_at,
            "updated_at": now,
        }

    def get_alerts(
        self,
        run_id: Optional[int] = None,
        *,
        state: Optional[str] = None,
        severity: Optional[str] = None,
        rule: Optional[str] = None,
        since_id: int = 0,
        limit: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Alert rows, cluster-wide when ``run_id`` is None — the /alerts
        feed.  since_id pages by transition (REPLACE bumps the id)."""
        sql = "SELECT * FROM alerts WHERE id > ?"
        params: List[Any] = [since_id]
        if run_id is not None:
            sql += " AND run_id = ?"
            params.append(run_id)
        if state is not None:
            sql += " AND state = ?"
            params.append(str(state))
        if severity is not None:
            sql += " AND severity = ?"
            params.append(str(severity))
        if rule is not None:
            sql += " AND rule = ?"
            params.append(str(rule))
        sql += " ORDER BY id"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        out: List[Dict[str, Any]] = []
        for r in rows:
            row = dict(r)
            row["attrs"] = json.loads(row["attrs"]) if row["attrs"] else {}
            out.append(row)
        return out

    def delete_alert(self, run_id: int, rule: str) -> bool:
        """Drop a (run, rule) alert row — a pending alert that recovered
        inside its hold-down vanishes instead of becoming a resolve edge."""
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                "DELETE FROM alerts WHERE run_id = ? AND rule = ?",
                (run_id, str(rule)),
            )
        return cur.rowcount > 0

    def stale_queued_runs(
        self, ttl_seconds: float, now: Optional[float] = None
    ) -> List[Run]:
        """Runs stuck in QUEUED past ``ttl_seconds`` since their last write.

        The QUEUED dispatch mark trades the old re-dispatch self-healing for
        debounce; if the dispatched build/start task is ever dropped (task
        error — the bus dead-letters non-Retry exceptions), the run would
        otherwise sit QUEUED forever with the group/pipeline waiting on it.
        The cron re-dispatches these.
        """
        now = now or time.time()
        rows = self._conn().execute(
            "SELECT * FROM runs WHERE status = ? AND ? - updated_at > ?",
            (S.QUEUED, now, ttl_seconds),
        ).fetchall()
        return list(map(_row_to_run, rows))

    # -- devices (accelerator inventory + gang admission) ---------------------
    # Parity: reference ``db/models/nodes.py`` (ClusterNode/NodeGPU) +
    # k8s-delegated placement. TPU-native: the schedulable unit is a whole
    # accelerator SLICE (chips within a slice share ICI and can't be split
    # across jax.distributed worlds), so the inventory is slices and
    # admission is acquire/release of one slice per gang.

    def register_device(
        self,
        name: str,
        accelerator: str,
        chips: int,
        num_hosts: int = 1,
    ) -> Dict[str, Any]:
        """Add (or update) a slice in the inventory. Registering any device
        of a family turns admission control ON for that family."""
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO devices (name, accelerator, chips, num_hosts,
                                        created_at, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?)
                   ON CONFLICT(name) DO UPDATE SET
                     accelerator = excluded.accelerator,
                     chips = excluded.chips,
                     num_hosts = excluded.num_hosts,
                     updated_at = excluded.updated_at""",
                (name, accelerator, chips, num_hosts, now, now),
            )
        return self.get_device(name)

    def get_device(self, name: str) -> Dict[str, Any]:
        row = self._conn().execute(
            "SELECT * FROM devices WHERE name = ?", (name,)
        ).fetchone()
        if row is None:
            raise RegistryError(f"No device named {name!r}")
        return dict(row)

    def list_devices(self) -> List[Dict[str, Any]]:
        """Inventory with usage accounting: ``used_chips`` counts packed
        claims (or the whole slice for an exclusive hold) and ``holders``
        names every run on the row — exclusive or packed."""
        rows = self._conn().execute(
            """SELECT d.*, COALESCE(SUM(c.chips), 0) AS packed_chips,
                      GROUP_CONCAT(c.run_id) AS packed_run_ids
               FROM devices d LEFT JOIN device_claims c ON c.device_id = d.id
               GROUP BY d.id
               ORDER BY d.accelerator, d.chips, d.name"""
        ).fetchall()
        out = []
        for r in rows:
            d = dict(r)
            packed = d.pop("packed_chips", 0) or 0
            packed_ids = d.pop("packed_run_ids", None)
            holders = (
                [int(x) for x in packed_ids.split(",")] if packed_ids else []
            )
            if d.get("run_id") is not None:
                holders = [d["run_id"]] + holders
            d["used_chips"] = d["chips"] if d.get("run_id") is not None else packed
            d["holders"] = holders
            out.append(d)
        return out

    def remove_device(self, name: str) -> bool:
        with self._lock, self._conn() as conn:
            cur = conn.execute("DELETE FROM devices WHERE name = ?", (name,))
        return cur.rowcount > 0

    def acquire_device(
        self,
        run_id: int,
        accelerator: str,
        chips: int,
        num_slices: int = 1,
        num_hosts: int = 1,
    ) -> Optional[Dict[str, Any]]:
        """Claim capacity for a gang: whole slice(s), or a PACKED share.

        Single-host single-slice gangs pack: they claim ``chips`` chips of
        a slice through the ``device_claims`` accounting table (best fit:
        the row with the least free space that still fits), so K small
        trials share one big slice — the reference's bread-and-butter
        hpsearch bin-packing (``scheduler/experiment_scheduler.py:
        101-140``, k8s-delegated there).  Gangs spanning hosts or slices
        still claim whole EXCLUSIVE rows — an ICI world is one
        ``jax.distributed`` job; splitting a multi-host slice between runs
        would interleave two coordinators on one ring.

        Returns the (first) claimed slice row; ``None`` when the family has
        inventory but nothing fits free (caller queues the run); or
        ``{"unmanaged": True}`` when the family has NO registered inventory
        at all (admission control off — every run admitted).  Idempotent
        per run: a re-dispatched start re-uses the already-held claim.
        All-or-nothing: a partial fit claims nothing.
        """
        num_slices = max(1, int(num_slices))
        if chips % num_slices:
            # Flooring would silently under-claim capacity; the compiler
            # always passes a divisible total, so a remainder is a caller bug.
            raise RegistryError(
                f"chips ({chips}) must divide evenly across num_slices "
                f"({num_slices})"
            )
        per_slice = max(1, chips // num_slices)
        packable = num_slices == 1 and int(num_hosts) <= 1
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            held = conn.execute(
                "SELECT * FROM devices WHERE run_id = ?", (run_id,)
            ).fetchone()
            if held is not None:
                # Flagged so a duplicate dispatch knows it did NOT newly
                # claim anything (and must not release on its failure path).
                return {**dict(held), "already_held": True}
            packed_held = conn.execute(
                """SELECT d.*, c.chips AS claim_chips FROM device_claims c
                   JOIN devices d ON d.id = c.device_id WHERE c.run_id = ?""",
                (run_id,),
            ).fetchone()
            if packed_held is not None:
                return {**dict(packed_held), "already_held": True, "packed": True}
            managed, free_clause, free_params = self._family_fit(
                conn, accelerator, per_slice
            )
            if managed == 0:
                return {"unmanaged": True}
            now = time.time()
            if packable:
                family_clause, family_params = self._family_clause(
                    accelerator, prefix="d."
                )
                row = conn.execute(
                    f"""SELECT d.*, d.chips - COALESCE(SUM(c.chips), 0)
                              AS free_chips
                        FROM devices d
                        LEFT JOIN device_claims c ON c.device_id = d.id
                        WHERE d.run_id IS NULL AND {family_clause}
                        GROUP BY d.id
                        HAVING free_chips >= ?
                        ORDER BY free_chips ASC, d.chips ASC, d.id ASC
                        LIMIT 1""",
                    (*family_params, per_slice),
                ).fetchone()
                if row is None:
                    return None
                conn.execute(
                    """INSERT INTO device_claims (device_id, run_id, chips,
                                                  created_at)
                       VALUES (?, ?, ?, ?)""",
                    (row["id"], run_id, per_slice, now),
                )
                claimed = dict(row)
                claimed.pop("free_chips", None)
                return {
                    **claimed,
                    "run_id": run_id,
                    "packed": True,
                    "claim_chips": per_slice,
                }
            rows = conn.execute(
                f"""SELECT * FROM devices d WHERE {free_clause}
                    AND NOT EXISTS (SELECT 1 FROM device_claims c
                                    WHERE c.device_id = d.id)
                    ORDER BY chips ASC, id ASC LIMIT ?""",
                (*free_params, num_slices),
            ).fetchall()
            if len(rows) < num_slices:
                return None
            for row in rows:
                conn.execute(
                    "UPDATE devices SET run_id = ?, updated_at = ? WHERE id = ?",
                    (run_id, now, row["id"]),
                )
            claimed = {**dict(rows[0]), "run_id": run_id}
            if num_slices > 1:
                claimed["slices"] = [r["name"] for r in rows]
            return claimed

    def release_devices(self, run_id: int) -> int:
        """Free everything held by ``run_id`` — exclusive slice rows AND
        packed claims; returns how many were held."""
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                "UPDATE devices SET run_id = NULL, updated_at = ? WHERE run_id = ?",
                (time.time(), run_id),
            )
            packed = conn.execute(
                "DELETE FROM device_claims WHERE run_id = ?", (run_id,)
            )
        return cur.rowcount + packed.rowcount

    @staticmethod
    def _family_clause(
        accelerator: str, prefix: str = "", col: Optional[str] = None
    ) -> Tuple[str, Tuple[Any, ...]]:
        """Family matching shared by acquire and the free count (they MUST
        agree or hp_start dispatches trials that then fail admission).

        Exact-name-or-dash-prefix: family ``v5e`` matches ``v5e`` and
        ``v5e-*`` but never ``v5`` → ``v5e-8`` (prefix LIKE would) —
        cross-generation chips aren't fungible.  ``col`` overrides the
        matched column/expression outright (queued-run counting matches a
        json_extract of the spec).
        """
        family = accelerator_family(accelerator)
        col = col or f"{prefix}accelerator"
        clause = f"({col} = ? OR {col} LIKE ? ESCAPE '\\')"
        like = family.replace("\\", "\\\\").replace("%", "\\%").replace("_", "\\_")
        return clause, (family, like + "-%")

    @classmethod
    def _family_fit(
        cls, conn: sqlite3.Connection, accelerator: str, chips: int
    ) -> Tuple[int, str, Tuple[Any, ...]]:
        family_clause, family_params = cls._family_clause(accelerator)
        managed = conn.execute(
            f"SELECT COUNT(*) AS n FROM devices WHERE {family_clause}",
            family_params,
        ).fetchone()["n"]
        free_clause = f"run_id IS NULL AND {family_clause} AND chips >= ?"
        return managed, free_clause, (*family_params, chips)

    def free_slice_count(
        self, accelerator: str, chips: int, num_hosts: int = 1
    ) -> Optional[int]:
        """Free fitting CLAIM OPPORTUNITIES for a family; None = family
        unmanaged (no inventory registered → admission control off).

        For packable requests (single host) this counts packing slots —
        Σ floor(free_chips / chips) over non-exclusive rows — so a sweep's
        dispatch window sees that a v5e-16 fits four 4-chip trials.  Multi-
        host requests count whole free unpacked slices, matching
        ``acquire_device``'s exclusive path.
        """
        conn = self._conn()
        managed, free_clause, free_params = self._family_fit(conn, accelerator, chips)
        if managed == 0:
            return None
        if int(num_hosts) > 1:
            return conn.execute(
                f"""SELECT COUNT(*) AS n FROM devices d WHERE {free_clause}
                    AND NOT EXISTS (SELECT 1 FROM device_claims c
                                    WHERE c.device_id = d.id)""",
                free_params,
            ).fetchone()["n"]
        family_clause, family_params = self._family_clause(accelerator, prefix="d.")
        rows = conn.execute(
            f"""SELECT d.chips - COALESCE(SUM(c.chips), 0) AS free_chips
                FROM devices d
                LEFT JOIN device_claims c ON c.device_id = d.id
                WHERE d.run_id IS NULL AND {family_clause}
                GROUP BY d.id""",
            family_params,
        ).fetchall()
        return sum(r["free_chips"] // chips for r in rows if r["free_chips"] >= chips)

    def queued_chips_count(self, accelerator: str) -> int:
        """Total CHIPS queued for this accelerator family — capacity
        already spoken for but not yet claimed.  hp_start converts this
        into its own slot units and subtracts it from the free count so
        two sweeps reading the same snapshot don't both dispatch into it
        (the losers would park QUEUED while holding their group's
        concurrency window — wave stalls).  Chips, not run counts: a
        queued 16-chip gang spends four of a 4-chip sweep's slots, and
        eight queued 1-chip trials spend two — run counting would get
        both wrong."""
        family_clause, family_params = self._family_clause(
            accelerator,
            col="COALESCE(json_extract(spec,"
            " '$.environment.topology.accelerator'), 'cpu')",
        )
        row = self._conn().execute(
            f"""SELECT SUM(
                    COALESCE(json_extract(spec,
                        '$.environment.topology.num_devices'), 1)
                    * COALESCE(json_extract(spec,
                        '$.environment.topology.num_slices'), 1)
                ) AS chips
                FROM runs WHERE status = 'queued' AND {family_clause}""",
            family_params,
        ).fetchone()
        return int(row["chips"] or 0)

    # -- iterations (hpsearch) ------------------------------------------------
    def create_iteration(self, group_id: int, data: Dict[str, Any]) -> int:
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute(
                "SELECT MAX(number) AS n FROM iterations WHERE group_id = ?",
                (group_id,),
            ).fetchone()
            number = (row["n"] or 0) + 1
            conn.execute(
                "INSERT INTO iterations (group_id, number, data, created_at, updated_at)"
                " VALUES (?, ?, ?, ?, ?)",
                (group_id, number, json.dumps(data), now, now),
            )
        return number

    def update_iteration(self, group_id: int, number: int, data: Dict[str, Any]) -> None:
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                "UPDATE iterations SET data = ?, updated_at = ? WHERE group_id = ? AND number = ?",
                (json.dumps(data), time.time(), group_id, number),
            )
            if cur.rowcount == 0:
                raise RegistryError(f"No iteration {number} for group {group_id}")

    def get_iteration(self, group_id: int, number: Optional[int] = None) -> Optional[Dict[str, Any]]:
        if number is None:
            row = self._conn().execute(
                "SELECT number, data FROM iterations WHERE group_id = ? ORDER BY number DESC LIMIT 1",
                (group_id,),
            ).fetchone()
        else:
            row = self._conn().execute(
                "SELECT number, data FROM iterations WHERE group_id = ? AND number = ?",
                (group_id, number),
            ).fetchone()
        if row is None:
            return None
        return {"number": row["number"], "data": json.loads(row["data"])}

    def get_iterations(self, group_id: int) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT number, data FROM iterations WHERE group_id = ? ORDER BY number",
            (group_id,),
        ).fetchall()
        return [{"number": r["number"], "data": json.loads(r["data"])} for r in rows]

    # -- processes (gang members) ---------------------------------------------
    def upsert_process(
        self,
        run_id: int,
        process_id: int,
        *,
        pid: Optional[int] = None,
        status: str = S.CREATED,
        exit_code: Optional[int] = None,
    ) -> None:
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO processes (run_id, process_id, pid, status, exit_code, updated_at)
                   VALUES (?, ?, ?, ?, ?, ?)
                   ON CONFLICT (run_id, process_id) DO UPDATE SET
                     pid = COALESCE(excluded.pid, pid),
                     status = excluded.status,
                     exit_code = COALESCE(excluded.exit_code, exit_code),
                     updated_at = excluded.updated_at""",
                (run_id, process_id, pid, status, exit_code, time.time()),
            )

    def get_processes(self, run_id: int) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT process_id, pid, status, exit_code, report_offset, updated_at"
            " FROM processes WHERE run_id = ? ORDER BY process_id",
            (run_id,),
        ).fetchall()
        return [dict(r) for r in rows]

    def set_report_offset(self, run_id: int, process_id: int, offset: int) -> None:
        """Persist the watcher's report-tail cursor — a restarted control
        plane resumes ingestion exactly where the dead one stopped (no
        replayed metrics, no lost final status lines)."""
        with self._lock, self._conn() as conn:
            conn.execute(
                "UPDATE processes SET report_offset = ? "
                "WHERE run_id = ? AND process_id = ?",
                (offset, run_id, process_id),
            )

    def clear_processes(self, run_id: int) -> None:
        with self._lock, self._conn() as conn:
            conn.execute("DELETE FROM processes WHERE run_id = ?", (run_id,))

    # -- activity log ----------------------------------------------------------
    def record_activity(self, event_type: str, context: Dict[str, Any]) -> None:
        with self._lock, self._conn() as conn:
            conn.execute(
                "INSERT INTO activity (event_type, context, created_at) VALUES (?, ?, ?)",
                (event_type, json.dumps(context, default=str), time.time()),
            )

    def get_activities(
        self, event_type: Optional[str] = None, limit: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        sql = "SELECT event_type, context, created_at FROM activity"
        params: List[Any] = []
        if event_type is not None:
            sql += " WHERE event_type = ?"
            params.append(event_type)
        sql += " ORDER BY id DESC"
        if limit is not None:
            sql += f" LIMIT {int(limit)}"
        rows = self._conn().execute(sql, params).fetchall()
        return [
            {
                "event_type": r["event_type"],
                "context": json.loads(r["context"]),
                "created_at": r["created_at"],
            }
            for r in rows
        ]

    # -- retention cleanup ----------------------------------------------------
    #: Retention sweep targets: (result key, table, age column, scope to
    #: finished runs?).  ``alerts``/``remediations`` key off ``updated_at``
    #: — a row's last lifecycle edge, not its creation, decides when it
    #: falls off the timeline (a long-lived firing alert must survive).
    _SWEEP_TABLES: Sequence[Tuple[str, str, str, bool]] = (
        ("activity", "activity", "created_at", False),
        ("logs", "logs", "created_at", True),
        ("spans", "spans", "created_at", True),
        ("anomalies", "anomalies", "created_at", True),
        ("utilization", "utilization", "created_at", True),
        ("commands", "commands", "created_at", True),
        ("captures", "captures", "created_at", True),
        ("alerts", "alerts", "updated_at", True),
        ("remediations", "remediations", "updated_at", True),
        # Fleet/control-plane series carry no run_id, so the sweep is
        # unscoped — age alone retires metric history.
        ("metric_samples", "metric_samples", "created_at", False),
    )

    def clean_old_rows(
        self,
        older_than_seconds: float,
        now: Optional[float] = None,
        max_rows: Optional[int] = None,
    ) -> Dict[str, int]:
        """Delete activity/log rows past the retention horizon for DONE runs.

        Parity: the reference's beat cleaners (``crons/tasks/cleaning.py``,
        activity-log & notification cleanup, archived deletion).

        One transaction per call, bounded by a per-tick row budget
        (``max_rows``, default ``POLYAXON_TPU_RETENTION_SWEEP_ROWS``): a
        registry that accumulated months of backlog must not hold the
        write lock for one giant sweep — leftovers age out on later
        ticks.  The result carries per-table delete counts plus
        ``truncated`` (1 when the budget ran out mid-sweep).
        """
        if max_rows is None:
            from polyaxon_tpu_torch.conf.knobs import knob_int

            max_rows = knob_int("POLYAXON_TPU_RETENTION_SWEEP_ROWS")
        now = now or time.time()
        cutoff = now - older_than_seconds
        budget = int(max_rows) if max_rows and max_rows > 0 else None
        counts: Dict[str, int] = {key: 0 for key, *_ in self._SWEEP_TABLES}
        truncated = False
        with self._lock, self._conn() as conn:
            for key, table, age_col, scoped in self._SWEEP_TABLES:
                if budget is not None and budget <= 0:
                    truncated = True
                    break
                # DELETE ... LIMIT isn't guaranteed compiled into the
                # stdlib's sqlite; the rowid-subselect form always works.
                scope = (
                    " AND run_id IN (SELECT id FROM runs WHERE"
                    " finished_at IS NOT NULL AND finished_at < ?)"
                    if scoped
                    else ""
                )
                params: List[Any] = [cutoff] + ([cutoff] if scoped else [])
                sql = (
                    f"DELETE FROM {table} WHERE rowid IN"
                    f" (SELECT rowid FROM {table} WHERE {age_col} < ?{scope}"
                )
                if budget is not None:
                    sql += " LIMIT ?"
                    params.append(budget)
                sql += ")"
                deleted = conn.execute(sql, params).rowcount
                counts[key] = deleted
                if budget is not None:
                    budget -= deleted
                    if budget <= 0 and deleted > 0:
                        truncated = True
        counts["truncated"] = int(truncated)
        return counts

    # -- projects (entity metadata over runs.project) --------------------------
    def create_project(
        self,
        name: str,
        description: Optional[str] = None,
        owner: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Parity: reference project CRUD (``api/projects/``) + ownership
        (``ownership/``): an ``owner`` scopes access to owner+collaborators
        (+admins); ownerless projects stay open — the pre-ACL behavior and
        the single-operator local mode."""
        try:
            with self._lock, self._conn() as conn:
                cur = conn.execute(
                    "INSERT INTO projects (name, description, owner, created_at)"
                    " VALUES (?, ?, ?, ?)",
                    (name, description, owner, time.time()),
                )
        except sqlite3.IntegrityError as e:
            raise RegistryError(f"Project {name!r} already exists") from e
        return {
            "id": cur.lastrowid,
            "name": name,
            "description": description,
            "owner": owner,
        }

    def add_collaborator(self, project: str, username: str) -> None:
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT OR IGNORE INTO project_collaborators
                   (project_name, username, created_at) VALUES (?, ?, ?)""",
                (project, username, time.time()),
            )

    def remove_collaborator(self, project: str, username: str) -> bool:
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                "DELETE FROM project_collaborators WHERE project_name = ?"
                " AND username = ?",
                (project, username),
            )
        return cur.rowcount > 0

    def project_collaborators(self, project: str) -> List[str]:
        rows = self._conn().execute(
            "SELECT username FROM project_collaborators WHERE project_name = ?"
            " ORDER BY username",
            (project,),
        ).fetchall()
        return [r["username"] for r in rows]

    def project_access(self, project: str, username: Optional[str]) -> bool:
        """May ``username`` touch ``project``?  Ownerless (or unregistered)
        projects are open; owned ones admit the owner and collaborators.
        Role checks (admin override) live at the API layer."""
        row = self._conn().execute(
            "SELECT owner FROM projects WHERE name = ?", (project,)
        ).fetchone()
        if row is None or row["owner"] in (None, ""):
            return True
        if username is None:
            return False
        if row["owner"] == username:
            return True
        return (
            self._conn().execute(
                "SELECT 1 FROM project_collaborators WHERE project_name = ?"
                " AND username = ?",
                (project, username),
            ).fetchone()
            is not None
        )

    def list_projects(self) -> List[Dict[str, Any]]:
        """Registered projects ∪ projects implied by runs, with run counts."""
        rows = self._conn().execute(
            """SELECT p.id AS id, p.name AS name, p.description AS description,
                      p.owner AS owner, p.created_at AS created_at,
                      COUNT(r.id) AS num_runs
               FROM projects p LEFT JOIN runs r ON r.project = p.name
               GROUP BY p.id
               UNION ALL
               SELECT NULL AS id, r.project AS name, NULL AS description,
                      NULL AS owner, MIN(r.created_at) AS created_at,
                      COUNT(*) AS num_runs
               FROM runs r
               WHERE r.project NOT IN (SELECT name FROM projects)
               GROUP BY r.project
               ORDER BY 2"""
        ).fetchall()
        return [dict(r) for r in rows]

    def get_project(self, name: str) -> Optional[Dict[str, Any]]:
        row = self._conn().execute(
            "SELECT id, name, description, owner, created_at FROM projects"
            " WHERE name = ?",
            (name,),
        ).fetchone()
        num_runs = self._conn().execute(
            "SELECT COUNT(*) FROM runs WHERE project = ?", (name,)
        ).fetchone()[0]
        if row is None:
            # Run-implied project (list_projects shows these too): the
            # detail endpoint must not 404 on names the listing returned,
            # and must return the SAME shape the listing used.
            if num_runs == 0:
                return None
            first = self._conn().execute(
                "SELECT MIN(created_at) FROM runs WHERE project = ?", (name,)
            ).fetchone()[0]
            return {"id": None, "name": name, "description": None,
                    "owner": None, "collaborators": [],
                    "created_at": first, "num_runs": num_runs}
        return {
            **dict(row),
            "num_runs": num_runs,
            "collaborators": self.project_collaborators(name),
        }

    def delete_project(self, name: str) -> Tuple[bool, List[Run]]:
        """Delete a project, cascading to its ARCHIVED runs (returned so
        the caller can GC their artifacts).  Refuses while live (non-
        archived) runs still reference it — archive-then-delete is the
        flow, matching the reference where only archived entities are
        deletable and ``project.delete()`` cascades."""
        live = self._conn().execute(
            "SELECT COUNT(*) FROM runs WHERE project = ? AND archived_at IS NULL",
            (name,),
        ).fetchone()[0]
        if live:
            raise RegistryError(
                f"Project {name!r} still has {live} live runs; archive or"
                " delete them first"
            )
        victims: List[Run] = []
        for row in self._conn().execute(
            "SELECT id FROM runs WHERE project = ?", (name,)
        ).fetchall():
            try:
                victims.extend(self.delete_run(row["id"]))
            except RegistryError:
                continue  # already cascaded away with an earlier parent
        with self._lock, self._conn() as conn:
            conn.execute(
                "DELETE FROM project_collaborators WHERE project_name = ?", (name,)
            )
            conn.execute("DELETE FROM project_ci WHERE project_name = ?", (name,))
            cur = conn.execute("DELETE FROM projects WHERE name = ?", (name,))
            return cur.rowcount > 0, victims

    # -- chart views (reference db/models/charts.py ChartViewModel) ------------
    def create_chart_view(
        self,
        run_id: int,
        name: str,
        charts: Any,
        meta: Optional[Dict[str, Any]] = None,
        owner: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Save a named chart configuration on a run (what metric set /
        layout the dashboard should plot).  Same-name saves replace —
        a view is a bookmarkable way of LOOKING at a run, not history."""
        if not self._run_exists(run_id):
            raise RegistryError(f"No run with id={run_id}")
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO chart_views (run_id, name, charts, meta, owner, created_at)
                   VALUES (?, ?, ?, ?, ?, ?)
                   ON CONFLICT (run_id, name) DO UPDATE
                   SET charts = excluded.charts, meta = excluded.meta""",
                (
                    run_id,
                    name,
                    json.dumps(charts),
                    json.dumps(meta or {}),
                    owner,
                    now,
                ),
            )
            # Read back INSIDE the lock: a concurrent delete between the
            # upsert and the select would hand _chart_view_row a None.
            row = conn.execute(
                "SELECT * FROM chart_views WHERE run_id = ? AND name = ?",
                (run_id, name),
            ).fetchone()
        return self._chart_view_row(row)

    @staticmethod
    def _chart_view_row(row: sqlite3.Row) -> Dict[str, Any]:
        return {
            "id": row["id"],
            "run_id": row["run_id"],
            "name": row["name"],
            "charts": json.loads(row["charts"]),
            "meta": json.loads(row["meta"]),
            "owner": row["owner"],
            "created_at": row["created_at"],
        }

    def list_chart_views(self, run_id: int) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT * FROM chart_views WHERE run_id = ? ORDER BY created_at",
            (run_id,),
        ).fetchall()
        return [self._chart_view_row(r) for r in rows]

    def delete_chart_view(self, run_id: int, view_id: int) -> bool:
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                "DELETE FROM chart_views WHERE run_id = ? AND id = ?",
                (run_id, view_id),
            )
        return cur.rowcount > 0

    # -- usage analytics (reference tracker/, served at /api/v1/analytics) -----
    def usage_rollup(
        self, days: int = 14, now: Optional[float] = None
    ) -> Dict[str, Any]:
        """Event counts per day + platform summary.  Counts come from the
        activity feed, so the window is bounded by the activity retention
        horizon (``logs.retention_days``, default 30)."""
        now = now or time.time()
        cutoff = now - days * 86400.0
        conn = self._conn()
        per_day: Dict[str, Dict[str, int]] = {}
        for row in conn.execute(
            """SELECT date(created_at, 'unixepoch') AS day, event_type,
                      COUNT(*) AS n
               FROM activity WHERE created_at >= ?
               GROUP BY day, event_type ORDER BY day""",
            (cutoff,),
        ):
            per_day.setdefault(row["day"], {})[row["event_type"]] = row["n"]
        runs_by_kind = {
            r["kind"]: r["n"]
            for r in conn.execute(
                "SELECT kind, COUNT(*) AS n FROM runs GROUP BY kind"
            )
        }
        runs_by_status = {
            r["status"]: r["n"]
            for r in conn.execute(
                "SELECT status, COUNT(*) AS n FROM runs GROUP BY status"
            )
        }
        return {
            "window_days": days,
            "events_per_day": per_day,
            "runs_by_kind": runs_by_kind,
            "runs_by_status": runs_by_status,
            "num_users": conn.execute("SELECT COUNT(*) FROM users").fetchone()[0],
            "num_projects": conn.execute(
                "SELECT COUNT(*) FROM projects"
            ).fetchone()[0],
            "num_devices": conn.execute(
                "SELECT COUNT(*) FROM devices"
            ).fetchone()[0],
        }

    # -- CI (per-project trigger config) ---------------------------------------
    # Parity: the reference's CI app (``api/ci/`` + ``ci/service.py``) —
    # a per-project toggle holding the spec to run whenever NEW code
    # arrives.  There "new code" is a repo commit; here it's a new
    # content-hashed snapshot ref (``stores/snapshots.py`` is the
    # dockerizer replacement, so the snapshot hash IS the code ref).

    def set_project_ci(self, project: str, spec: Dict[str, Any]) -> Dict[str, Any]:
        now = time.time()
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO project_ci (project_name, spec, created_at, updated_at)
                   VALUES (?, ?, ?, ?)
                   ON CONFLICT (project_name) DO UPDATE
                   SET spec = excluded.spec, updated_at = excluded.updated_at,
                       last_code_ref = NULL""",
                (project, json.dumps(spec), now, now),
            )
        return self.get_project_ci(project)

    def get_project_ci(self, project: str) -> Optional[Dict[str, Any]]:
        row = self._conn().execute(
            "SELECT * FROM project_ci WHERE project_name = ?", (project,)
        ).fetchone()
        if row is None:
            return None
        return {
            "project": row["project_name"],
            "spec": json.loads(row["spec"]),
            "last_code_ref": row["last_code_ref"],
            "created_at": row["created_at"],
            "updated_at": row["updated_at"],
        }

    def delete_project_ci(self, project: str) -> bool:
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                "DELETE FROM project_ci WHERE project_name = ?", (project,)
            )
        return cur.rowcount > 0

    def advance_ci_code_ref(self, project: str, code_ref: str) -> bool:
        """Record ``code_ref`` as seen; True only when it was NEW (the
        reference's ``CIService.sync`` code-ref comparison) — the atomic
        check-and-set is what makes concurrent triggers fire once."""
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                """UPDATE project_ci SET last_code_ref = ?, updated_at = ?
                   WHERE project_name = ? AND
                         (last_code_ref IS NULL OR last_code_ref != ?)""",
                (code_ref, time.time(), project, code_ref),
            )
        return cur.rowcount > 0

    # -- saved searches (reference api/searches/) ------------------------------
    def create_search(
        self, name: str, query: str, owner: Optional[str] = None
    ) -> Dict[str, Any]:
        try:
            with self._lock, self._conn() as conn:
                cur = conn.execute(
                    "INSERT INTO searches (name, query, owner, created_at)"
                    " VALUES (?, ?, ?, ?)",
                    (name, query, owner, time.time()),
                )
        except sqlite3.IntegrityError as e:
            raise RegistryError(f"Search {name!r} already exists") from e
        return {"id": cur.lastrowid, "name": name, "query": query, "owner": owner}

    def list_searches(self) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT id, name, query, owner, created_at FROM searches ORDER BY name"
        ).fetchall()
        return [dict(r) for r in rows]

    def get_search(self, name: str) -> Optional[Dict[str, Any]]:
        row = self._conn().execute(
            "SELECT id, name, query, owner FROM searches WHERE name = ?", (name,)
        ).fetchone()
        return dict(row) if row else None

    def delete_search(self, name: str) -> bool:
        with self._lock, self._conn() as conn:
            cur = conn.execute("DELETE FROM searches WHERE name = ?", (name,))
            return cur.rowcount > 0

    # -- bookmarks (reference api/bookmarks/) ----------------------------------
    def add_bookmark(self, run_id: int, owner: str = "") -> None:
        self.get_run(run_id)  # 404 before write
        with self._lock, self._conn() as conn:
            conn.execute(
                "INSERT OR IGNORE INTO bookmarks (run_id, owner, created_at)"
                " VALUES (?, ?, ?)",
                (run_id, owner, time.time()),
            )

    def remove_bookmark(self, run_id: int, owner: str = "") -> bool:
        with self._lock, self._conn() as conn:
            cur = conn.execute(
                "DELETE FROM bookmarks WHERE run_id = ? AND owner = ?",
                (run_id, owner),
            )
            return cur.rowcount > 0

    def list_bookmarked_runs(self, owner: str = "") -> List[Run]:
        rows = self._conn().execute(
            """SELECT runs.* FROM runs
               JOIN bookmarks ON bookmarks.run_id = runs.id
               WHERE bookmarks.owner = ? ORDER BY bookmarks.created_at DESC""",
            (owner,),
        ).fetchall()
        return [_row_to_run(r) for r in rows]

    # -- users (per-user API tokens) -------------------------------------------
    @staticmethod
    def _token_hash(token: str) -> str:
        import hashlib

        # surrogateescape: a garbage (non-UTF-8) Authorization header must
        # hash to a non-match, not raise into a 500.
        return hashlib.sha256(
            token.encode("utf-8", "surrogateescape")
        ).hexdigest()

    def create_user(self, username: str, role: str = "user") -> Tuple[Dict[str, Any], str]:
        """Create a user and mint their token (returned ONCE, stored hashed).

        Parity: reference users + per-user auth tokens (``scopes/``,
        ``db/models`` user tables) — collapsed to username/role/token.
        """
        import secrets

        if role not in ("admin", "user"):
            raise RegistryError(f"Unknown role {role!r} (admin|user)")
        token = secrets.token_hex(20)
        try:
            with self._lock, self._conn() as conn:
                cur = conn.execute(
                    "INSERT INTO users (username, token_hash, role, created_at)"
                    " VALUES (?, ?, ?, ?)",
                    (username, self._token_hash(token), role, time.time()),
                )
                user_id = cur.lastrowid
        except sqlite3.IntegrityError as e:
            raise RegistryError(f"User {username!r} already exists") from e
        return {"id": user_id, "username": username, "role": role}, token

    def ensure_sso_user(
        self, provider: str, username: str, role: str = "user"
    ) -> Tuple[Dict[str, Any], str]:
        """Upsert the SSO identity ``provider:username``, minting a FRESH
        token (returned once, stored hashed) — every login rotates it, so
        a stale leaked token dies at the next sign-in.  Existing role is
        preserved (an admin promoted in-platform stays admin).

        An identity only ever matches a user row CREATED BY THE SAME
        PROVIDER: a locally-minted user (or another provider's) with a
        colliding name is a hard error, never a takeover — on a public
        provider anyone can register any free username."""
        if role not in ("admin", "user"):
            raise RegistryError(f"Unknown role {role!r} (admin|user)")
        import secrets

        token = secrets.token_hex(20)
        with self._lock, self._conn() as conn:
            row = conn.execute(
                "SELECT id, role, sso_provider FROM users WHERE username = ?",
                (username,),
            ).fetchone()
            if row is not None and row["sso_provider"] != provider:
                kind = (
                    "locally-created"
                    if not row["sso_provider"]
                    else f"{row['sso_provider']}-linked"
                )
                raise RegistryError(
                    f"A {kind} user named {username!r} already exists; "
                    f"refusing to link the {provider} identity to it"
                )
            if row is None:
                cur = conn.execute(
                    "INSERT INTO users (username, token_hash, role,"
                    " sso_provider, created_at) VALUES (?, ?, ?, ?, ?)",
                    (
                        username,
                        self._token_hash(token),
                        role,
                        provider,
                        time.time(),
                    ),
                )
                return (
                    {
                        "id": cur.lastrowid,
                        "username": username,
                        "role": role,
                        "created": True,
                    },
                    token,
                )
            conn.execute(
                "UPDATE users SET token_hash = ? WHERE id = ?",
                (self._token_hash(token), row["id"]),
            )
            return (
                {
                    "id": row["id"],
                    "username": username,
                    "role": row["role"],
                    "created": False,
                },
                token,
            )

    def get_user(self, username: str) -> Optional[Dict[str, Any]]:
        row = self._conn().execute(
            "SELECT id, username, role, sso_provider, last_used_at FROM users"
            " WHERE username = ?",
            (username,),
        ).fetchone()
        return dict(row) if row is not None else None

    def get_user_by_token(self, token: str) -> Optional[Dict[str, Any]]:
        row = self._conn().execute(
            "SELECT id, username, role, last_used_at FROM users WHERE token_hash = ?",
            (self._token_hash(token),),
        ).fetchone()
        if row is None:
            return None
        now = time.time()
        # last_used_at is observability, not security: refresh at most once
        # a minute so the hot auth path isn't a write transaction per call.
        if row["last_used_at"] is None or now - row["last_used_at"] > 60.0:
            with self._lock, self._conn() as conn:
                conn.execute(
                    "UPDATE users SET last_used_at = ? WHERE id = ?",
                    (now, row["id"]),
                )
        return {k: row[k] for k in ("id", "username", "role")}

    def list_users(self) -> List[Dict[str, Any]]:
        rows = self._conn().execute(
            "SELECT id, username, role, created_at, last_used_at FROM users"
            " ORDER BY username"
        ).fetchall()
        return [dict(r) for r in rows]

    def remove_user(self, username: str) -> bool:
        with self._lock, self._conn() as conn:
            cur = conn.execute("DELETE FROM users WHERE username = ?", (username,))
            return cur.rowcount > 0

    def has_users(self) -> bool:
        return self._conn().execute("SELECT 1 FROM users LIMIT 1").fetchone() is not None

    # -- options (DB-backed conf store) ---------------------------------------
    def set_option(self, key: str, value: Any) -> None:
        with self._lock, self._conn() as conn:
            conn.execute(
                """INSERT INTO options (key, value) VALUES (?, ?)
                   ON CONFLICT (key) DO UPDATE SET value = excluded.value""",
                (key, json.dumps(value)),
            )

    def get_option(self, key: str, default: Any = None) -> Any:
        row = self._conn().execute(
            "SELECT value FROM options WHERE key = ?", (key,)
        ).fetchone()
        return json.loads(row["value"]) if row else default

    def delete_option(self, key: str) -> None:
        with self._lock, self._conn() as conn:
            conn.execute("DELETE FROM options WHERE key = ?", (key,))


# Instrument every public RunRegistry method with the op-family timer.
# Done once at import — the per-call cost without an attached stats
# backend is one attribute check inside the wrapper.
import types as _types

for _name, _fn in list(vars(RunRegistry).items()):
    if (
        _name.startswith("_")
        or _name in ("attach_stats", "close")
        or not isinstance(_fn, _types.FunctionType)
    ):
        continue
    setattr(RunRegistry, _name, _timed_op(_name, _fn))
del _name, _fn
