"""REST + WebSocket API over the orchestrator.

The port's copy of ``polyaxon_tpu/api/app.py``: the same routes over the
port's ``Orchestrator``.  Its departures: ``/api/v1/version`` reports torch
and its CUDA where the reference reports jax, and ``/api/v1/status?devices=1``
adds the card probe.  aiohttp and torch load inside the functions that need
them, so importing this module loads neither.

Parity: the reference's DRF surface (``api/experiments/views.py`` — list/
detail :120-280, stop/restart/resume/copy :281-368, statuses :468, metric
ingestion :495-509) and its Sanic streams service (``streams/api.py:14-45``,
``streams/resources/experiments.py:22-113`` — WS log/metric tailing).
TPU-native collapse: one aiohttp app over the embedded orchestrator; live
tailing reads the registry's cursor-friendly rows (statuses/metrics/logs
are ordinary ordered rows), no RabbitMQ/Redis fan-out needed.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Dict, Optional

from polyaxon_tpu_torch.conf.knobs import knob_int, knob_str
from polyaxon_tpu_torch.db.registry import RemediationStatus, Run, RunRegistry
from polyaxon_tpu_torch.events import EventTypes
from polyaxon_tpu_torch.exceptions import PolyaxonTPUError
from polyaxon_tpu_torch.monitor.alerts import RuleContext, run_slo_status
from polyaxon_tpu_torch.monitor.watcher import anomaly_status, goodput_status
from polyaxon_tpu_torch.orchestrator import Orchestrator
from polyaxon_tpu_torch.stats.metrics import (
    PROMETHEUS_CONTENT_TYPE,
    labeled_key,
    render_prometheus,
    render_standard_gauges,
    split_labeled_key,
)
from polyaxon_tpu_torch.tracking.trace import chrome_trace

logger = logging.getLogger(__name__)

API_PREFIX = "/api/v1"

#: Status classes for the per-route request counter — a fixed vocabulary
#: (never the raw code) keeps the label set bounded.
_STATUS_CLASSES = {1: "1xx", 2: "2xx", 3: "3xx", 4: "4xx", 5: "5xx"}


def run_to_dict(run: Run) -> Dict[str, Any]:
    return {
        "id": run.id,
        "uuid": run.uuid,
        "kind": run.kind,
        "name": run.name,
        "project": run.project,
        "status": run.status,
        "group_id": run.group_id,
        "pipeline_id": run.pipeline_id,
        "original_id": run.original_id,
        "cloning_strategy": run.cloning_strategy,
        "restarts": run.restarts,
        "tags": run.tags,
        "last_metric": run.last_metric,
        "service_url": run.service_url,
        "is_done": run.is_done,
        "created_at": run.created_at,
        "started_at": run.started_at,
        "finished_at": run.finished_at,
        "archived_at": run.archived_at,
        "spec": run.spec_data,
    }


def create_app(orch: Orchestrator, auth_token: Optional[str] = None):
    """``auth_token`` enables bearer-token access control (reference
    ``scopes/`` permission classes + ephemeral/internal tokens, collapsed
    to one shared-secret scheme); ``/api/v1/status`` stays open for health
    probes, like the reference's ``/status`` endpoint."""
    from aiohttp import WSMsgType, web

    routes = web.RouteTableDef()
    reg: RunRegistry = orch.registry

    def _int_param(request, name: str, default: Optional[int] = None) -> Optional[int]:
        raw = request.rel_url.query.get(name)
        if raw is None:
            return default
        try:
            return int(raw)
        except ValueError:
            raise web.HTTPBadRequest(
                text=json.dumps({"error": f"query param {name!r} must be an integer"}),
                content_type="application/json",
            )

    def _float_param(
        request, name: str, default: Optional[float] = None
    ) -> Optional[float]:
        raw = request.rel_url.query.get(name)
        if raw is None:
            return default
        try:
            return float(raw)
        except ValueError:
            raise web.HTTPBadRequest(
                text=json.dumps({"error": f"query param {name!r} must be a number"}),
                content_type="application/json",
            )

    def _audit(request, event_type, **ctx):
        # Every mutating entity action lands in the activity feed with the
        # authenticated actor (reference events carry actor attributes).
        actor = request.get("actor")
        if actor:
            ctx["actor"] = actor
        orch.auditor.record(event_type, **ctx)

    def _json_error(exc_cls, message: str):
        """An aiohttp HTTP error carrying the API's JSON error shape."""
        return exc_cls(
            text=json.dumps({"error": message}),
            content_type="application/json",
        )

    def _project_denied(request, project: str) -> bool:
        """Project-scoped access (reference ``ownership/`` + ``scopes/``):
        owned projects admit owner + collaborators; admins (including the
        open-mode anonymous admin) see everything; ownerless projects stay
        open."""
        if request.get("role") == "admin":
            return False
        return not reg.project_access(project, request.get("actor"))

    def _require_project(request, project: str) -> None:
        if _project_denied(request, project):
            raise _json_error(
                web.HTTPForbidden, f"no access to project {project!r}"
            )

    def _require_project_owner(request, project: str) -> None:
        """Owner-or-admin gate for project administration (delete, share)."""
        if request.get("role") == "admin":
            return
        proj = reg.get_project(project)
        owner = (proj or {}).get("owner")
        if owner and owner != request.get("actor"):
            raise _json_error(
                web.HTTPForbidden,
                f"only the owner of {project!r} (or an admin) may do this",
            )

    def _run_or_404(request) -> Run:
        try:
            run = reg.get_run(int(request.match_info["run_id"]))
        except PolyaxonTPUError:
            raise web.HTTPNotFound(
                text=json.dumps({"error": f"run {request.match_info['run_id']} not found"}),
                content_type="application/json",
            )
        # Every run endpoint rides this lookup, so the project ACL holds
        # across detail/actions/logs/metrics/artifacts/WS uniformly.
        _require_project(request, run.project)
        return run

    @routes.get("/")
    async def dashboard(request):
        from polyaxon_tpu_torch.api.dashboard import DASHBOARD_HTML

        return web.Response(text=DASHBOARD_HTML, content_type="text/html")

    @routes.get(f"{API_PREFIX}/status")
    async def status(request):
        # Health surface (reference checks/ + api/index/status.py). The
        # endpoint stays open for probes; operational task counters ride
        # the payload only for admins (or when auth is off entirely) —
        # task names and failure volumes are internal data.
        from polyaxon_tpu_torch.checks import run_health_checks, task_counter_snapshot

        # ``?devices=1`` adds the card probe (``check_devices``, which loads
        # torch): a departure that only adds, for a host that serves on the
        # card.  Without it the report is the reference's.
        report = run_health_checks(
            orch, include_devices=request.query.get("devices") in ("1", "true")
        )
        required = request.get("auth_required", True)
        show_counters = not required
        if required:
            resolved = _resolve_actor(request)
            show_counters = resolved is not None and resolved[1] == "admin"
        if show_counters:
            counters = task_counter_snapshot(orch)
            if counters:
                report["task_counters"] = counters
        code = 200 if report["healthy"] else 503
        return web.json_response(report, status=code)

    @routes.get("/metrics")
    async def prometheus_metrics(request):
        # Prometheus scrape surface over the control plane's own stats
        # backend (task throughput/latency histograms, watcher timings).
        # Auth-gated like the rest of the API — scrape configs carry
        # ``authorization: {credentials: <token>}``; only an in-memory
        # backend has state to export (statsd/noop render a comment).
        snapshot_fn = getattr(orch.stats, "snapshot", None)
        if snapshot_fn is None:
            body = f"# stats backend {type(orch.stats).__name__} keeps no in-process registry\n"
        else:
            # The renderer only reads counters/gauges/histograms, so skip
            # the raw timing-window copy — by far the largest lock-held
            # cost of a scrape (up to 512 floats per key).
            try:
                snap = snapshot_fn(include_timings=False)
            except TypeError:  # duck-typed stand-in without the kwarg
                snap = snapshot_fn()
            body = render_prometheus(snap, labels={"component": "control_plane"})
        # Exposition hygiene: standard process/build gauges render even
        # when the stats backend keeps no registry.
        body += render_standard_gauges(labels={"component": "control_plane"})
        return web.Response(
            body=body.encode("utf-8"),
            headers={"Content-Type": PROMETHEUS_CONTENT_TYPE},
        )

    # -- runs CRUD + actions --------------------------------------------------
    @routes.post(f"{API_PREFIX}/runs")
    async def create_run(request):
        body = await request.json()
        _require_project(request, body.get("project", "default"))
        try:
            run = orch.submit(
                body.get("spec") or body.get("content"),
                project=body.get("project", "default"),
                name=body.get("name"),
                tags=body.get("tags"),
                actor=request.get("actor"),
            )
        except PolyaxonTPUError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(run_to_dict(run), status=201)

    @routes.get(f"{API_PREFIX}/runs")
    async def list_runs(request):
        q = request.rel_url.query
        statuses = q.getall("status", []) or None
        limit = _int_param(request, "limit", 100)
        offset = _int_param(request, "offset", 0)
        # DSL conditions on real columns push down to SQL WHERE; only
        # JSON-payload conditions (metric.*, declarations.*, tags) filter
        # in process — and only those force fetch-then-paginate.
        from polyaxon_tpu_torch.query import (
            QueryError,
            apply_query,
            compile_to_sql,
            filters_archived,
            parse_query,
        )

        try:
            conds = parse_query(q.get("q"))
            clauses, params, residual = compile_to_sql(conds)
        except QueryError as e:
            return web.json_response({"error": str(e)}, status=400)
        # In-process filters (residual DSL conditions, project ACLs under
        # auth) must see the FULL result set before pagination — slicing
        # first would return empty/short pages while accessible runs sit
        # beyond them.  Admins skip the ACL fetch-all: the filter is a
        # no-op for them and SQL LIMIT/OFFSET is exact.
        post_filter = bool(residual) or (
            request.get("auth_required", False)
            and request.get("role") != "admin"
        )
        # ?archived=true → archived only; ?archived=all → both; default =
        # live runs only (the reference's default model manager).  A query
        # that filters on `archived:` itself takes over — stacking the
        # default exclusion under it would contradict the user's filter.
        archived_q = (q.get("archived") or "").lower()
        archived = {"true": True, "1": True, "all": None}.get(archived_q, False)
        if filters_archived(conds):
            archived = None
        runs = reg.list_runs(
            kind=q.get("kind"),
            project=q.get("project"),
            group_id=_int_param(request, "group_id"),
            pipeline_id=_int_param(request, "pipeline_id"),
            statuses=statuses,
            extra_where=(clauses, params) if clauses else None,
            limit=None if post_filter else limit,
            offset=0 if post_filter else offset,
            archived=archived,
        )
        if residual:
            runs = apply_query(runs, conditions=residual)
        # Owned projects are invisible to outsiders, not just read-only
        # (reference private projects). One ACL decision per project name.
        decided: Dict[str, bool] = {}
        visible = []
        for r in runs:
            if r.project not in decided:
                decided[r.project] = not _project_denied(request, r.project)
            if decided[r.project]:
                visible.append(r)
        if post_filter:
            visible = visible[offset : offset + limit]
        return web.json_response({"results": [run_to_dict(r) for r in visible]})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}")
    async def get_run(request):
        run = _run_or_404(request)
        payload = run_to_dict(run)
        # Live stall/straggler roll-up — detail view only, so list views
        # stay a single-table read.  A finished run cannot be stalled: its
        # progress rows age out, but the alarm must not outlive the gang
        # (the heartbeat stays "fresh" for heartbeat_fresh_s after exit).
        status = anomaly_status(reg, run.id)
        if run.is_done:
            status.update(stalled=False, stall_age_s=0.0, stragglers=[])
        payload["anomalies"] = status
        # Goodput/MFU roll-up block (no timeline — /goodput serves that).
        payload["goodput"] = goodput_status(reg, run.id, timeline_limit=0)
        # Alert roll-up: current lifecycle state per rule + counts, so the
        # detail view answers "is anything paging on this run" directly.
        alert_rows = reg.get_alerts(run.id)
        payload["alerts"] = {
            "firing": sum(1 for r in alert_rows if r["state"] == "firing"),
            "pending": sum(1 for r in alert_rows if r["state"] == "pending"),
            "resolved": sum(1 for r in alert_rows if r["state"] == "resolved"),
            "results": alert_rows,
        }
        # SLO roll-up: the run's declared error budget with both burn
        # windows and budget remaining — None unless the run declares
        # ``alert.slo_burn_rate.target`` and the metric store is live.
        metrics_store = getattr(orch, "metrics", None)
        if metrics_store is not None:
            try:
                payload["slo"] = run_slo_status(
                    RuleContext(reg, run, stats=orch.stats, metrics=metrics_store)
                )
            except Exception:
                logger.warning("SLO roll-up failed for run %d", run.id, exc_info=True)
                payload["slo"] = None
        else:
            payload["slo"] = None
        # Remediation roll-up: what the control plane DID about trouble
        # (checkpoint-now, resume-from-step, eviction) — the action half
        # of the alerts block above.
        rem_rows = reg.get_remediations(run.id)
        payload["remediations"] = {
            "total": len(rem_rows),
            "open": sum(
                1 for r in rem_rows if r["status"] in RemediationStatus.OPEN
            ),
            "results": rem_rows,
        }
        return web.json_response(payload)

    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/stop")
    async def stop_run(request):
        run = _run_or_404(request)
        orch.stop_run(run.id, actor=request.get("actor"))
        return web.json_response({"ok": True})

    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/restart")
    async def restart_run(request):
        run = _run_or_404(request)
        clone = orch.clone_run(run.id, strategy="restart", actor=request.get("actor"))
        return web.json_response(run_to_dict(clone), status=201)

    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/resume")
    async def resume_run(request):
        run = _run_or_404(request)
        clone = orch.clone_run(run.id, strategy="resume", actor=request.get("actor"))
        return web.json_response(run_to_dict(clone), status=201)

    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/copy")
    async def copy_run(request):
        run = _run_or_404(request)
        clone = orch.clone_run(run.id, strategy="copy", actor=request.get("actor"))
        return web.json_response(run_to_dict(clone), status=201)

    # -- chart views (reference ChartViewModel + its experiment/group views) --
    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/chart_views")
    async def create_chart_view(request):
        run = _run_or_404(request)
        body = await request.json()
        name = (body.get("name") or "").strip()
        charts = body.get("charts")
        if not name or not isinstance(charts, list) or not all(
            isinstance(c, str) for c in charts
        ):
            return web.json_response(
                {
                    "error": "a chart view needs a 'name' and 'charts' "
                    "(a list of metric names)"
                },
                status=400,
            )
        view = reg.create_chart_view(
            run.id,
            name,
            charts,
            meta=body.get("meta"),
            owner=request.get("actor"),
        )
        _audit(request, EventTypes.CHART_VIEW_CREATED, run_id=run.id, name=name)
        return web.json_response(view, status=201)

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/chart_views")
    async def list_chart_views(request):
        run = _run_or_404(request)
        return web.json_response({"results": reg.list_chart_views(run.id)})

    @routes.delete(f"{API_PREFIX}/runs/{{run_id}}/chart_views/{{view_id}}")
    async def delete_chart_view(request):
        run = _run_or_404(request)
        try:
            view_id = int(request.match_info["view_id"])
        except ValueError:
            raise _json_error(web.HTTPNotFound, "no such chart view")
        if not reg.delete_chart_view(run.id, view_id):
            raise _json_error(web.HTTPNotFound, "no such chart view")
        _audit(request, EventTypes.CHART_VIEW_DELETED, run_id=run.id, view_id=view_id)
        return web.json_response({"ok": True})

    # -- archival + deletion (reference api/archives/ + delete views) ---------
    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/archive")
    async def archive_run(request):
        run = _run_or_404(request)
        orch.archive_run(run.id, actor=request.get("actor"))
        return web.json_response(run_to_dict(reg.get_run(run.id)))

    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/restore")
    async def restore_run(request):
        run = _run_or_404(request)
        orch.restore_run(run.id, actor=request.get("actor"))
        return web.json_response(run_to_dict(reg.get_run(run.id)))

    @routes.delete(f"{API_PREFIX}/runs/{{run_id}}")
    async def delete_run(request):
        run = _run_or_404(request)
        deleted = orch.delete_run(run.id, actor=request.get("actor"))
        return web.json_response({"ok": True, "deleted": deleted})

    @routes.get(f"{API_PREFIX}/archives")
    async def list_archives(request):
        """Archived runs, visible-project-filtered (reference archives API)."""
        runs = reg.list_runs(archived=True)
        decided: Dict[str, bool] = {}
        visible = []
        for r in runs:
            if r.project not in decided:
                decided[r.project] = not _project_denied(request, r.project)
            if decided[r.project]:
                visible.append(r)
        return web.json_response({"results": [run_to_dict(r) for r in visible]})

    # -- sub-resources --------------------------------------------------------
    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/statuses")
    async def get_statuses(request):
        run = _run_or_404(request)
        return web.json_response({"results": reg.get_statuses(run.id)})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/metrics")
    async def get_metrics(request):
        run = _run_or_404(request)
        since = _int_param(request, "since_id", 0)
        return web.json_response({"results": reg.get_metrics(run.id, since_id=since)})

    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/metrics")
    async def post_metrics(request):
        # In-job metric ingestion (reference ExperimentMetricListView).
        run = _run_or_404(request)
        body = await request.json()
        reg.add_metric(run.id, body.get("values", {}), step=body.get("step"))
        return web.json_response({"ok": True}, status=201)

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/logs")
    async def get_logs(request):
        run = _run_or_404(request)
        rows = reg.get_logs(
            run.id,
            since_id=_int_param(request, "since_id", 0),
            limit=_int_param(request, "limit"),
        )
        return web.json_response({"results": rows})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/timeline")
    async def get_timeline(request):
        # Cross-process gang timeline: tracer spans reported by every
        # worker, assembled into Chrome-trace JSON (load in Perfetto or
        # chrome://tracing; pid = gang process id).
        run = _run_or_404(request)
        spans = reg.get_spans(run.id, since_id=_int_param(request, "since_id", 0))
        fmt = request.rel_url.query.get("format", "chrome")
        if fmt == "spans":
            # Raw registry rows for programmatic consumers.
            return web.json_response({"results": spans})
        if fmt != "chrome":
            return web.json_response(
                {"error": f"unknown timeline format {fmt!r}"}, status=400
            )
        return web.json_response(chrome_trace(spans))

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/goodput")
    async def get_goodput(request):
        # Per-run utilization ledger: gang-wide wall-clock decomposition
        # (buckets sum to wall time), goodput ratio, live MFU timeline,
        # compile/HBM telemetry — plus the raw per-process ledger rows
        # with since_id/limit paging for pollers.
        run = _run_or_404(request)
        status = goodput_status(reg, run.id)
        rows = reg.get_utilization(
            run.id,
            since_id=_int_param(request, "since_id", 0),
            limit=_int_param(request, "limit"),
        )
        status["results"] = rows
        return web.json_response(status)

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/anomalies")
    async def get_anomalies(request):
        # Incident timeline (stall/straggler/crash rows from the detector
        # and the workers' flight recorders) + the live detector roll-up.
        run = _run_or_404(request)
        rows = reg.get_anomalies(
            run.id,
            since_id=_int_param(request, "since_id", 0),
            limit=_int_param(request, "limit"),
        )
        status = anomaly_status(reg, run.id)
        if run.is_done:
            # The incident rows are history; the live roll-up is not —
            # a finished run cannot be currently stalled or straggling.
            status.update(stalled=False, stall_age_s=0.0, stragglers=[])
        return web.json_response({"results": rows, "status": status})

    # -- alerts (rule-engine lifecycle feed) ----------------------------------
    def _visible_alert_rows(request, rows):
        """Project-ACL filter for cluster-wide alert rows: one decision per
        run, same invisibility rule as the run list."""
        decided: Dict[int, bool] = {}
        out = []
        for row in rows:
            rid = row["run_id"]
            if rid not in decided:
                try:
                    run = reg.get_run(rid)
                    decided[rid] = not _project_denied(request, run.project)
                except PolyaxonTPUError:
                    decided[rid] = False
            if decided[rid]:
                out.append(row)
        return out

    @routes.get(f"{API_PREFIX}/alerts")
    async def list_alerts(request):
        # Cluster-wide alert feed: latest state per (run, rule), pageable
        # by transition (?since_id=), filterable by state/severity/rule/run.
        rows = reg.get_alerts(
            run_id=_int_param(request, "run_id"),
            state=request.query.get("state"),
            severity=request.query.get("severity"),
            rule=request.query.get("rule"),
            since_id=_int_param(request, "since_id", 0),
            limit=_int_param(request, "limit"),
        )
        engine = getattr(orch, "alerts", None)
        return web.json_response(
            {
                "results": _visible_alert_rows(request, rows),
                "engine": engine.status() if engine is not None else None,
            }
        )

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/alerts")
    async def get_run_alerts(request):
        run = _run_or_404(request)
        rows = reg.get_alerts(
            run.id,
            state=request.query.get("state"),
            severity=request.query.get("severity"),
            rule=request.query.get("rule"),
            since_id=_int_param(request, "since_id", 0),
            limit=_int_param(request, "limit"),
        )
        return web.json_response({"results": rows})

    # -- remediations (the detection→action audit trail) ----------------------
    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/remediations")
    async def get_run_remediations(request):
        run = _run_or_404(request)
        rows = reg.get_remediations(
            run.id,
            action=request.query.get("action"),
            status=request.query.get("status"),
            since_id=_int_param(request, "since_id", 0),
            limit=_int_param(request, "limit"),
        )
        engine = getattr(orch, "remediation", None)
        return web.json_response(
            {
                "results": rows,
                "engine": engine.status() if engine is not None else None,
            }
        )

    # -- metric history (registry TSDB: scrape → rollup → query) --------------
    #: Query params with reserved meaning on /metrics/query — everything
    #: else is treated as a label matcher (?fleet=prod&run=12).
    _QUERY_RESERVED = {"series", "name", "since", "until", "step", "agg", "limit"}

    def _metric_store(request):
        store = getattr(orch, "metrics", None)
        if store is None:
            raise _json_error(
                web.HTTPServiceUnavailable,
                "metric history disabled (POLYAXON_TPU_TSDB_ENABLED=false)",
            )
        return store

    def _require_metric_access(request, store, base: str, matchers) -> None:
        """Project ACL for the in-memory series: a run-labeled query is
        gated by that run's project; aggregating run-labeled series
        *across* runs (no ``run`` matcher) is admin-only, because the
        result would blend projects the caller may not see.  Cluster
        series (router/control-plane) are visible to any authed caller."""
        run_label = matchers.get("run")
        if run_label is not None:
            try:
                target = reg.get_run(int(run_label))
            except (ValueError, PolyaxonTPUError):
                raise _json_error(web.HTTPNotFound, f"run {run_label!r} not found")
            _require_project(request, target.project)
            return
        if request.get("role") == "admin":
            return
        for key in store.series_keys(base):
            _sbase, labels = split_labeled_key(key)
            if "run" in labels:
                raise _json_error(
                    web.HTTPForbidden,
                    f"series {base!r} is run-labeled: pass ?run=<id> "
                    "(cross-run aggregation is admin-only)",
                )

    @routes.get(f"{API_PREFIX}/metrics/query")
    async def metrics_query(request):
        store = _metric_store(request)
        name = request.query.get("series") or request.query.get("name")
        if not name:
            raise _json_error(
                web.HTTPBadRequest, "query param 'series' is required"
            )
        base, inline = split_labeled_key(name)
        if not store.has_series(base):
            raise _json_error(web.HTTPBadRequest, f"unknown series {base!r}")
        matchers = {
            k: v for k, v in request.query.items() if k not in _QUERY_RESERVED
        }
        _require_metric_access(request, store, base, {**inline, **matchers})
        max_points = knob_int("POLYAXON_TPU_TSDB_QUERY_MAX_POINTS")
        limit = _int_param(request, "limit", max_points)
        limit = max(1, min(limit, max_points))
        agg = request.query.get("agg", "avg")
        step = _float_param(request, "step")
        try:
            points = store.query(
                name,
                matchers=matchers,
                since=_float_param(request, "since"),
                until=_float_param(request, "until"),
                step=step,
                agg=agg,
                limit=limit,
            )
        except ValueError as exc:
            raise _json_error(web.HTTPBadRequest, str(exc))
        return web.json_response(
            {
                "series": name,
                "matchers": matchers,
                "agg": agg,
                "step": step,
                "points": points,
            }
        )

    @routes.get(f"{API_PREFIX}/metrics/series")
    async def metrics_series(request):
        store = _metric_store(request)
        return web.json_response(
            {"results": store.series_names(), "store": store.status()}
        )

    @routes.get(f"{API_PREFIX}/metrics/baselines")
    async def metrics_baselines(request):
        project = request.query.get("project", "default")
        _require_project(request, project)
        rows = reg.get_metric_baselines(project, kind=request.query.get("kind"))
        return web.json_response({"results": rows})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/metrics/history")
    async def run_metric_history(request):
        # Persisted per-run samples (raw + rollups) — survives control-plane
        # restarts, unlike the in-memory query window above.
        run = _run_or_404(request)
        agg = request.query.get("agg", "raw")
        rows = reg.get_metric_samples(
            run_id=run.id,
            name=request.query.get("series") or request.query.get("name"),
            agg=None if agg == "all" else agg,
            since=_float_param(request, "since"),
            until=_float_param(request, "until"),
            since_id=_int_param(request, "since_id", 0),
            limit=_int_param(request, "limit"),
        )
        return web.json_response({"results": rows})

    # -- on-demand device profiling (run command bus) -------------------------
    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/profile")
    async def post_profile(request):
        # Trigger a gang-wide windowed capture (xplane + device memory +
        # HLO) over the command bus.  A finished run answers immediately
        # with a typed EXPIRED command row — never a hang.
        run = _run_or_404(request)
        body = await request.json() if request.can_read_body else {}
        num_steps = body.get("num_steps")
        duration_s = body.get("duration_s")
        processes = body.get("processes")
        if processes is not None and (
            not isinstance(processes, list)
            or not all(isinstance(p, int) for p in processes)
        ):
            return web.json_response(
                {"error": "'processes' must be a list of gang process ids"},
                status=400,
            )
        try:
            cmd = await asyncio.to_thread(
                orch.request_profile,
                run.id,
                num_steps=int(num_steps) if num_steps is not None else None,
                duration_s=float(duration_s) if duration_s is not None else None,
                processes=processes,
                actor=request.get("actor"),
            )
        except (TypeError, ValueError) as exc:
            return web.json_response({"error": str(exc)}, status=400)
        return web.json_response(cmd, status=202)

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/profiles")
    async def list_profiles(request):
        # Capture index: every profile command (bus lifecycle rollup) plus
        # the per-host capture rows the watcher ingested so far.
        run = _run_or_404(request)
        commands = reg.get_commands(
            run.id,
            kind="profile",
            since_id=_int_param(request, "since_id", 0),
            limit=_int_param(request, "limit"),
        )
        captures = reg.get_captures(run.id)
        by_capture: Dict[str, list] = {}
        for row in captures:
            by_capture.setdefault(row["capture_id"], []).append(row)
        results = []
        for cmd in commands:
            results.append(
                {
                    **cmd,
                    "capture_id": cmd["uuid"],
                    "captures": by_capture.get(cmd["uuid"], []),
                }
            )
        return web.json_response({"results": results})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/profiles/{{capture_id}}")
    async def get_profile(request):
        # Per-capture manifest: bus command state, per-host capture rows
        # (status + artifact keys fetchable via the artifacts API), and a
        # merged chrome-trace of the gang's span ring over the capture
        # window (?format=chrome for the raw trace document).
        run = _run_or_404(request)
        capture_id = request.match_info["capture_id"]
        cmd = reg.get_command(capture_id)
        if cmd is None or cmd["run_id"] != run.id or cmd["kind"] != "profile":
            raise _json_error(web.HTTPNotFound, "no such capture")
        captures = reg.get_captures(run.id, capture_id=capture_id)
        window_start = min(
            (c["started_at"] for c in captures if c.get("started_at")),
            default=None,
        )
        window_end = max(
            (c["finished_at"] for c in captures if c.get("finished_at")),
            default=None,
        )
        trace = None
        if window_start is not None:
            end = window_end if window_end is not None else float("inf")
            spans = [
                s
                for s in reg.get_spans(run.id)
                if s["start"] < end
                and s["start"] + (s.get("duration") or 0.0) >= window_start
            ]
            trace = chrome_trace(spans)
        fmt = request.rel_url.query.get("format", "manifest")
        if fmt == "chrome":
            if trace is None:
                return web.json_response(
                    {"error": "capture has no span window yet"}, status=404
                )
            return web.json_response(trace)
        if fmt != "manifest":
            return web.json_response(
                {"error": f"unknown profile format {fmt!r}"}, status=400
            )
        return web.json_response(
            {
                "capture_id": capture_id,
                "command": cmd,
                "captures": captures,
                "window": {"start": window_start, "end": window_end},
                "trace": trace,
            }
        )

    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/heartbeat")
    async def post_heartbeat(request):
        run = _run_or_404(request)
        reg.ping_heartbeat(run.id)
        return web.json_response({"ok": True})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/iterations")
    async def get_iterations(request):
        # Sweep iteration state (reference ExperimentGroupIteration rows):
        # hyperband brackets / BO observation rounds, per iteration.
        run = _run_or_404(request)
        return web.json_response({"results": reg.get_iterations(run.id)})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/processes")
    async def get_processes(request):
        run = _run_or_404(request)
        return web.json_response({"results": reg.get_processes(run.id)})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/artifacts")
    async def list_artifacts(request):
        # Outputs browsing (reference stores-managed outputs endpoints):
        # local run dir first, artifact store as the durable fallback.
        run = _run_or_404(request)
        # Store listing may shell out to gsutil — keep it off the event loop.
        results = await asyncio.to_thread(orch.list_artifacts, run.id)
        return web.json_response({"results": results})

    @routes.get(f"{API_PREFIX}/runs/{{run_id}}/artifacts/{{key:.+}}")
    async def get_artifact(request):
        run = _run_or_404(request)
        key = request.match_info["key"]
        local = orch.artifact_local_path(run.id, key)
        if local is not None:
            return web.FileResponse(local)  # sendfile, zero-copy
        # Store fallback: the open (gsutil cp to a temp file) blocks for the
        # transfer — keep it off the event loop — then stream chunks so a
        # multi-GB checkpoint never sits in control-plane memory.
        f = await asyncio.to_thread(orch.open_artifact, run.id, key)
        if f is None:
            raise web.HTTPNotFound(
                text=json.dumps({"error": f"artifact {key!r} not found"}),
                content_type="application/json",
            )
        resp = web.StreamResponse(
            headers={"Content-Type": "application/octet-stream"}
        )
        await resp.prepare(request)
        try:
            while True:
                chunk = await asyncio.to_thread(f.read, 1 << 20)
                if not chunk:
                    break
                await resp.write(chunk)
        finally:
            f.close()
        await resp.write_eof()
        return resp

    # -- projects (reference api/projects/) ------------------------------------
    @routes.post(f"{API_PREFIX}/projects")
    async def create_project(request):
        body = await request.json()
        # Under auth the creator owns the project (reference ``ownership/``);
        # an explicit body owner — including null for a deliberately open
        # project — overrides; open mode (anonymous admin) stays ownerless.
        actor = request.get("actor")
        is_admin = request.get("role") == "admin"
        if "owner" in body:
            owner = body["owner"]
        else:
            owner = actor if actor not in (None, "anonymous") else None
        if not is_admin:
            # Non-admins may only own projects themselves (no assigning
            # ownership to third parties)...
            if owner not in (None, actor):
                raise _json_error(
                    web.HTTPForbidden, "only admins may assign another owner"
                )
            # ...and may not CLAIM a run-implied project others already use
            # (registering 'ml' with an owner would 403 every existing
            # user of it — an ownership takeover).
            if owner is not None and reg.get_project(body.get("name", "")):
                raise _json_error(
                    web.HTTPForbidden,
                    "project already has runs; an admin must register its "
                    "ownership",
                )
        try:
            project = reg.create_project(
                body["name"], description=body.get("description"), owner=owner
            )
        except KeyError:
            return web.json_response({"error": "project needs a name"}, status=400)
        except PolyaxonTPUError as e:
            return web.json_response({"error": str(e)}, status=400)
        _audit(request, EventTypes.PROJECT_CREATED, project=project["name"])
        return web.json_response(project, status=201)

    @routes.get(f"{API_PREFIX}/projects")
    async def list_projects(request):
        results = [
            p
            for p in reg.list_projects()
            if not _project_denied(request, p["name"])
        ]
        return web.json_response({"results": results})

    @routes.get(f"{API_PREFIX}/projects/{{name}}")
    async def get_project(request):
        _require_project(request, request.match_info["name"])
        project = reg.get_project(request.match_info["name"])
        if project is None:
            raise web.HTTPNotFound(
                text=json.dumps({"error": "no such project"}),
                content_type="application/json",
            )
        return web.json_response(project)

    @routes.delete(f"{API_PREFIX}/projects/{{name}}")
    async def delete_project(request):
        _require_project_owner(request, request.match_info["name"])
        try:
            # Orchestrator-level: cascades to the project's archived runs
            # and GCs their artifacts; refuses while live runs exist.
            removed = orch.delete_project(
                request.match_info["name"], actor=request.get("actor")
            )
        except PolyaxonTPUError as e:
            return web.json_response({"error": str(e)}, status=400)
        if not removed:
            raise web.HTTPNotFound(
                text=json.dumps({"error": "no such project"}),
                content_type="application/json",
            )
        return web.json_response({"ok": True})

    @routes.post(f"{API_PREFIX}/projects/{{name}}/collaborators")
    async def add_collaborator(request):
        name = request.match_info["name"]
        _require_project_owner(request, name)
        body = await request.json()
        username = body.get("username")
        if not username:
            return web.json_response(
                {"error": "collaborator needs a username"}, status=400
            )
        if reg.get_project(name) is None:
            raise _json_error(web.HTTPNotFound, "no such project")
        reg.add_collaborator(name, username)
        _audit(
            request, EventTypes.PROJECT_SHARED, project=name, username=username
        )
        return web.json_response(reg.get_project(name), status=201)

    @routes.delete(f"{API_PREFIX}/projects/{{name}}/collaborators/{{username}}")
    async def remove_collaborator(request):
        name = request.match_info["name"]
        _require_project_owner(request, name)
        if not reg.remove_collaborator(name, request.match_info["username"]):
            raise _json_error(web.HTTPNotFound, "not a collaborator")
        _audit(
            request,
            EventTypes.PROJECT_UNSHARED,
            project=name,
            username=request.match_info["username"],
        )
        return web.json_response({"ok": True})

    # -- CI (reference api/ci/: per-project trigger config) --------------------
    @routes.put(f"{API_PREFIX}/projects/{{name}}/ci")
    async def set_ci(request):
        name = request.match_info["name"]
        _require_project_owner(request, name)
        body = await request.json()
        spec = body.get("spec") or body.get("content")
        if not spec:
            return web.json_response(
                {"error": "CI needs a 'spec' to run on new code"}, status=400
            )
        try:
            ci = orch.set_project_ci(name, spec, actor=request.get("actor"))
        except PolyaxonTPUError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(ci, status=201)

    @routes.get(f"{API_PREFIX}/projects/{{name}}/ci")
    async def get_ci(request):
        name = request.match_info["name"]
        _require_project(request, name)
        ci = reg.get_project_ci(name)
        if ci is None:
            raise _json_error(web.HTTPNotFound, f"no CI configured for {name!r}")
        return web.json_response(ci)

    @routes.delete(f"{API_PREFIX}/projects/{{name}}/ci")
    async def delete_ci(request):
        name = request.match_info["name"]
        _require_project_owner(request, name)
        if not orch.delete_project_ci(name, actor=request.get("actor")):
            raise _json_error(web.HTTPNotFound, f"no CI configured for {name!r}")
        return web.json_response({"ok": True})

    @routes.post(f"{API_PREFIX}/projects/{{name}}/ci/trigger")
    async def trigger_ci(request):
        """Manual code-push check (the reference repo-upload trigger).
        ``context`` is a SERVER-side directory — owner/admin only, like
        every surface that reads the service host's filesystem."""
        name = request.match_info["name"]
        _require_project_owner(request, name)
        body = await request.json() if request.can_read_body else {}
        try:
            run = orch.trigger_ci(
                name, context=body.get("context"), actor=request.get("actor")
            )
        except PolyaxonTPUError as e:
            return web.json_response({"error": str(e)}, status=400)
        if run is None:
            return web.json_response({"triggered": False})
        return web.json_response(
            {"triggered": True, "run": run_to_dict(run)}, status=201
        )

    # -- saved searches (reference api/searches/) -------------------------------
    @routes.post(f"{API_PREFIX}/searches")
    async def create_search(request):
        from polyaxon_tpu_torch.query import QueryError, compile_to_sql, parse_query

        body = await request.json()
        try:
            # Validate at save time — a stored search must never 400 later.
            compile_to_sql(parse_query(body["query"]))
            search = reg.create_search(
                body["name"], body["query"], owner=request.get("actor")
            )
        except KeyError:
            return web.json_response(
                {"error": "search needs name and query"}, status=400
            )
        except (QueryError, PolyaxonTPUError) as e:
            return web.json_response({"error": str(e)}, status=400)
        _audit(request, EventTypes.SEARCH_CREATED, search=search["name"])
        return web.json_response(search, status=201)

    @routes.get(f"{API_PREFIX}/searches")
    async def list_searches(request):
        return web.json_response({"results": reg.list_searches()})

    @routes.delete(f"{API_PREFIX}/searches/{{name}}")
    async def delete_search(request):
        if not reg.delete_search(request.match_info["name"]):
            raise web.HTTPNotFound(
                text=json.dumps({"error": "no such search"}),
                content_type="application/json",
            )
        _audit(request, EventTypes.SEARCH_DELETED, search=request.match_info["name"])
        return web.json_response({"ok": True})

    @routes.get(f"{API_PREFIX}/searches/{{name}}/runs")
    async def execute_search(request):
        from polyaxon_tpu_torch.query import apply_query, compile_to_sql, parse_query

        search = reg.get_search(request.match_info["name"])
        if search is None:
            raise web.HTTPNotFound(
                text=json.dumps({"error": "no such search"}),
                content_type="application/json",
            )
        from polyaxon_tpu_torch.query import filters_archived

        search_conds = parse_query(search["query"])
        clauses, params, residual = compile_to_sql(search_conds)
        limit = _int_param(request, "limit", 100)
        runs = reg.list_runs(
            extra_where=(clauses, params) if clauses else None,
            limit=None if residual else limit,
            # A search over `archived:` owns that dimension; otherwise
            # the live-only default applies.
            archived=None if filters_archived(search_conds) else False,
        )
        if residual:
            runs = apply_query(runs, conditions=residual)[:limit]
        return web.json_response({"results": [run_to_dict(r) for r in runs]})

    # -- bookmarks (reference api/bookmarks/) ----------------------------------
    def _bookmark_owner(request) -> str:
        # '' == anonymous, shared with local-CLI bookmarks on the same
        # base dir; authenticated users get per-user bookmarks.
        actor = request.get("actor")
        return "" if actor in (None, "anonymous") else actor

    @routes.post(f"{API_PREFIX}/runs/{{run_id}}/bookmark")
    async def add_bookmark(request):
        run = _run_or_404(request)
        reg.add_bookmark(run.id, owner=_bookmark_owner(request))
        _audit(request, EventTypes.BOOKMARK_ADDED, run_id=run.id)
        return web.json_response({"ok": True}, status=201)

    @routes.delete(f"{API_PREFIX}/runs/{{run_id}}/bookmark")
    async def remove_bookmark(request):
        run = _run_or_404(request)
        if not reg.remove_bookmark(run.id, owner=_bookmark_owner(request)):
            raise web.HTTPNotFound(
                text=json.dumps({"error": "not bookmarked"}),
                content_type="application/json",
            )
        _audit(request, EventTypes.BOOKMARK_REMOVED, run_id=run.id)
        return web.json_response({"ok": True})

    @routes.get(f"{API_PREFIX}/bookmarks")
    async def list_bookmarks(request):
        runs = reg.list_bookmarked_runs(owner=_bookmark_owner(request))
        return web.json_response({"results": [run_to_dict(r) for r in runs]})

    # -- runtime options (reference options API / cluster settings) -----------
    @routes.get(f"{API_PREFIX}/options")
    async def list_options(request):
        # The full typed registry with resolved values. Admin-gated: values
        # include operational secrets-adjacent settings (hosts, key paths).
        _require_admin(request)
        from polyaxon_tpu_torch.conf.options import options_payload

        return web.json_response({"results": options_payload(orch.conf)})

    @routes.put(f"{API_PREFIX}/options/{{key}}")
    async def set_option(request):
        _require_admin(request)
        from polyaxon_tpu_torch.conf.options import display_value, option_by_key
        from polyaxon_tpu_torch.conf.service import ConfError

        key = request.match_info["key"]
        opt = option_by_key(key)
        if opt is None:
            raise web.HTTPNotFound(
                text=json.dumps({"error": f"unknown option {key!r}"}),
                content_type="application/json",
            )
        try:
            body = await request.json()
            orch.conf.set(key, body["value"])
        except (KeyError, TypeError, ValueError, ConfError) as e:
            # Covers malformed JSON bodies too (JSONDecodeError is a
            # ValueError) — bad input is a 400, never a 500.
            return web.json_response({"error": str(e)}, status=400)
        _audit(request, "platform.option_set", key=key)
        return web.json_response(
            {"key": key, "value": display_value(opt, orch.conf.get(key))}
        )

    @routes.get(f"{API_PREFIX}/activities")
    async def list_activities(request):
        # The audit feed (reference activitylogs/): who did what, when.
        # Admin-gated — it carries usernames and every actor's actions,
        # the same data GET /users restricts.
        _require_admin(request)
        rows = reg.get_activities(
            event_type=request.rel_url.query.get("event_type"),
            limit=_int_param(request, "limit", 100),
        )
        return web.json_response({"results": rows})

    # -- devices (accelerator inventory) --------------------------------------
    @routes.get(f"{API_PREFIX}/devices")
    async def list_devices(request):
        # Cluster inventory (reference nodes API, ``api/nodes/``).
        return web.json_response({"results": reg.list_devices()})

    @routes.post(f"{API_PREFIX}/devices")
    async def register_device(request):
        body = await request.json()
        try:
            device = orch.register_device(
                body["name"],
                body["accelerator"],
                int(body["chips"]),
                num_hosts=int(body.get("num_hosts", 1)),
                actor=request.get("actor"),
            )
        except (KeyError, TypeError, ValueError) as e:
            return web.json_response(
                {"error": f"device needs name/accelerator/chips: {e}"}, status=400
            )
        return web.json_response(device, status=201)

    @routes.delete(f"{API_PREFIX}/devices/{{name}}")
    async def remove_device(request):
        removed = reg.remove_device(request.match_info["name"])
        if not removed:
            raise web.HTTPNotFound(
                text=json.dumps({"error": "no such device"}),
                content_type="application/json",
            )
        return web.json_response({"ok": True})

    # -- versions (reference api/versions/: cli/platform compatibility) -------
    @routes.get(f"{API_PREFIX}/version")
    async def version(request):
        from polyaxon_tpu_torch import __version__

        # The port's one departure here: it reports torch and its CUDA where
        # the reference reports jax, imported in the handler so that the
        # control plane loads no torch until a client asks.
        import torch

        return web.json_response(
            {
                "platform": __version__,
                # Clients older than this may speak an incompatible spec
                # dialect (the reference's min/latest CLI gate).
                "min_cli": "0.1.0",
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
            }
        )

    # -- usage analytics (reference tracker/, kept in-house) -------------------
    @routes.get(f"{API_PREFIX}/analytics")
    async def analytics(request):
        """Platform usage rollup: event counts per day + entity summary.
        Admin-only — aggregate usage is operator data."""
        _require_admin(request)
        from polyaxon_tpu_torch.tracker import usage_rollup

        days = _int_param(request, "days", 14)
        return web.json_response(usage_rollup(reg, days=days))

    # -- query vocabulary (dashboard autocomplete) ----------------------------
    @routes.get(f"{API_PREFIX}/query/fields")
    async def query_fields(request):
        """The completable query-DSL vocabulary: plain columns, the
        metric./declarations. keys present in current runs, and known
        status values.  Parity: the reference client's autocomplete
        component fed from its query spec (``client/src/components/
        autocomplete/``); here the backend that owns the grammar
        (``query/builder.py``) serves it."""
        from polyaxon_tpu_torch.lifecycles import StatusOptions
        from polyaxon_tpu_torch.query.builder import _FIELDS

        metric_keys, param_keys = set(), set()
        decided: Dict[str, bool] = {}
        for r in reg.list_runs(limit=500, archived=False):
            # Same per-project ACL as every listing surface: keys harvested
            # from restricted projects must not leak into completions.
            if r.project not in decided:
                decided[r.project] = not _project_denied(request, r.project)
            if not decided[r.project]:
                continue
            metric_keys.update(
                k for k in r.last_metric if not k.startswith("sys/")
            )
            param_keys.update(r.spec_data.get("declarations", {}) or {})
        statuses = sorted(
            v
            for k, v in vars(StatusOptions).items()
            if k.isupper() and isinstance(v, str)
        )
        return web.json_response(
            {
                "fields": sorted(_FIELDS) + ["archived", "tags"],
                "metric_keys": sorted(metric_keys),
                "param_keys": sorted(param_keys),
                "statuses": statuses,
                "ops": [":", ":~", ":>", ":>=", ":<", ":<=", "|", ".."],
            }
        )

    # -- live streaming (WS) --------------------------------------------------
    ws_tails_active = [0]  # closure-shared gauge source across tail handlers

    async def _ws_tail(request, fetch, poll: float = 0.5, scoped: bool = True):
        """Generic WS tail loop: push new rows until the run is done.

        ``scoped=False`` is the cluster-feed variant (no run in the path):
        ``fetch`` gets None for the run id and the loop never sees a
        terminal run, so it streams until the client hangs up.

        Fan-out is batch-capped (``POLYAXON_TPU_WS_TAIL_MAX_BATCH``): a
        cold tail over a huge history drains in bounded bursts — the
        cursor only advances over rows actually sent, so the remainder is
        re-fetched immediately (no poll sleep while a backlog stands).
        ``ws_tail_backlog_rows`` exports the standing depth; a client that
        hangs up mid-drain counts its unsent rows as drops."""
        run = _run_or_404(request) if scoped else None
        stats = orch.stats
        max_batch = knob_int("POLYAXON_TPU_WS_TAIL_MAX_BATCH")
        # Select ONLY the fixed ``bearer`` name (browsers abort the
        # handshake if the server selects none of the offered protocols,
        # so the dashboard offers ['bearer', 'bearer.<token>']).  Echoing
        # the client's full offer would reflect the bearer.<token> auth
        # subprotocol — the secret — into the Sec-WebSocket-Protocol
        # RESPONSE header, where proxies and devtools log it.
        ws = web.WebSocketResponse(heartbeat=30, protocols=("bearer",))
        await ws.prepare(request)
        cursor = 0
        backlog = 0
        ws_tails_active[0] += 1
        stats.gauge("ws_tail_active", float(ws_tails_active[0]))
        try:
            while not ws.closed:
                # The run can be DELETEd out from under a live tail; close
                # the stream cleanly instead of crashing the handler.
                try:
                    rows = fetch(run.id if run else None, cursor)
                    current = reg.get_run(run.id) if run else None
                except PolyaxonTPUError:
                    await ws.send_json({"event": "deleted"})
                    break
                backlog = max(0, len(rows) - max_batch) if max_batch > 0 else 0
                if backlog:
                    rows = rows[:max_batch]
                stats.gauge("ws_tail_backlog_rows", float(backlog))
                for row in rows:
                    cursor = max(cursor, row.get("id", cursor))
                    await ws.send_json(row)
                if rows:
                    stats.incr("ws_tail_rows_total", len(rows))
                if current is not None and current.is_done and not rows:
                    await ws.send_json({"event": "done", "status": current.status})
                    break
                if backlog:
                    continue  # deferred rows re-fetch now, not after poll
                try:
                    msg = await asyncio.wait_for(ws.receive(), timeout=poll)
                    if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.ERROR):
                        break
                except asyncio.TimeoutError:
                    pass
        finally:
            ws_tails_active[0] -= 1
            stats.gauge("ws_tail_active", float(ws_tails_active[0]))
            if backlog:
                stats.incr("ws_tail_dropped_rows_total", backlog)
            await ws.close()
        return ws

    @routes.get("/ws/v1/runs/{run_id}/logs")
    async def ws_logs(request):
        return await _ws_tail(
            request, lambda rid, cur: reg.get_logs(rid, since_id=cur)
        )

    @routes.get("/ws/v1/runs/{run_id}/metrics")
    async def ws_metrics(request):
        return await _ws_tail(
            request, lambda rid, cur: reg.get_metrics(rid, since_id=cur)
        )

    @routes.get("/ws/v1/alerts")
    async def ws_alerts(request):
        # Cluster-wide live alert tail: every lifecycle transition is a
        # fresh row id, so the generic cursor loop streams exactly the
        # pending→firing→resolved edges (ACL-filtered like the REST feed).
        state = request.query.get("state")
        severity = request.query.get("severity")
        return await _ws_tail(
            request,
            lambda _rid, cur: _visible_alert_rows(
                request,
                reg.get_alerts(since_id=cur, state=state, severity=severity),
            ),
            scoped=False,
        )

    @routes.get("/ws/v1/metrics")
    async def ws_cluster_metrics(request):
        # Cluster-wide live metric tail over the persisted sample feed:
        # every flushed scrape row is a fresh id, so the generic cursor
        # loop streams raw samples as the write-behind lands them.
        # Row visibility mirrors the alert feed: run-labeled samples are
        # project-gated, cluster samples (run_id NULL) are open to any
        # authed caller.
        name = request.query.get("series") or request.query.get("name")
        agg = request.query.get("agg", "raw")
        decided: Dict[int, bool] = {}

        def _visible_metric_rows(rows):
            out = []
            for row in rows:
                rid = row.get("run_id")
                if rid is None:
                    out.append(row)
                    continue
                if rid not in decided:
                    try:
                        target = reg.get_run(rid)
                        decided[rid] = not _project_denied(request, target.project)
                    except PolyaxonTPUError:
                        decided[rid] = False
                if decided[rid]:
                    out.append(row)
            return out

        return await _ws_tail(
            request,
            lambda _rid, cur: _visible_metric_rows(
                reg.get_metric_samples(
                    since_id=cur, name=name, agg=None if agg == "all" else agg
                )
            ),
            scoped=False,
        )

    # -- users (per-user tokens; reference scopes/ + user models) --------------
    def _actor_for_token(token: str):
        import hmac

        if auth_token and hmac.compare_digest(
            token.encode("utf-8", "surrogateescape"), auth_token.encode()
        ):
            return ("root", "admin")
        user = reg.get_user_by_token(token)
        if user is not None:
            return (user["username"], user["role"])
        return None

    def _resolve_actor(request):
        """(actor, role) for the supplied bearer token; None = bad token.

        The shared bootstrap token maps to the 'root' admin; user tokens
        are looked up hashed in the registry.  WS upgrades may carry the
        token as a ``bearer.<token>`` subprotocol instead — the browser
        WebSocket API cannot set an Authorization header, and a ``?token=``
        query param would land the secret in access logs/history (the same
        reason the dashboard login is a form).
        """
        supplied = request.headers.get("Authorization", "")
        if supplied.startswith("Bearer "):
            return _actor_for_token(supplied[len("Bearer "):])
        if request.path.startswith("/ws/"):
            for proto in request.headers.get("Sec-WebSocket-Protocol", "").split(","):
                proto = proto.strip()
                if proto.startswith("bearer."):
                    return _actor_for_token(proto[len("bearer."):])
        return None

    def _require_admin(request):
        if request.get("role") != "admin":
            raise web.HTTPForbidden(
                text=json.dumps({"error": "admin role required"}),
                content_type="application/json",
            )

    @routes.post(f"{API_PREFIX}/users")
    async def create_user(request):
        _require_admin(request)
        body = await request.json()
        try:
            user, token = reg.create_user(
                body["username"], role=body.get("role", "user")
            )
        except (KeyError, PolyaxonTPUError) as e:
            return web.json_response({"error": str(e)}, status=400)
        # The token is shown exactly once; only its hash is stored.
        _audit(request, EventTypes.USER_CREATED, username=user["username"])
        return web.json_response({**user, "token": token}, status=201)

    @routes.get(f"{API_PREFIX}/users")
    async def list_users(request):
        _require_admin(request)
        return web.json_response({"results": reg.list_users()})

    @routes.delete(f"{API_PREFIX}/users/{{username}}")
    async def remove_user(request):
        _require_admin(request)
        if not reg.remove_user(request.match_info["username"]):
            raise web.HTTPNotFound(
                text=json.dumps({"error": "no such user"}),
                content_type="application/json",
            )
        _audit(request, EventTypes.USER_DELETED, username=request.match_info["username"])
        return web.json_response({"ok": True})

    # -- SSO (reference polyaxon/sso/ provider wizards) ------------------------
    from polyaxon_tpu_torch.api.sso import (
        CALLBACK_HTML,
        SSOError,
        StateStore,
        authenticate,
        authorize_redirect_url,
        resolve_provider,
    )

    sso_states = StateStore()

    def _sso_redirect_uri(request) -> str:
        base = orch.conf.get("sso.redirect_base") or f"{request.scheme}://{request.host}"
        return f"{base.rstrip('/')}/auth/sso/callback"

    def _sso_provider_or_error(request):
        try:
            provider = resolve_provider(orch.conf)
        except SSOError as e:
            # Half-configured SSO (oidc without endpoint URLs) must fail
            # with the same clean JSON shape as every other misconfig.
            raise _json_error(web.HTTPBadRequest, str(e))
        if provider is None:
            raise _json_error(web.HTTPNotFound, "SSO is not configured")
        return provider

    @routes.get("/auth/sso/login")
    async def sso_login(request):
        provider = _sso_provider_or_error(request)
        state = sso_states.issue()
        resp = web.HTTPFound(
            authorize_redirect_url(
                provider,
                client_id=orch.conf.get("sso.client_id"),
                redirect_uri=_sso_redirect_uri(request),
                state=state,
            )
        )
        # Bind the state to THIS browser: server-side issuance alone can't
        # stop a login-CSRF where an attacker feeds a victim a callback
        # URL carrying the attacker's own valid state+code (session
        # fixation into the attacker's account).
        resp.set_cookie(
            "px_sso_state", state, httponly=True, samesite="Lax", max_age=600
        )
        raise resp

    @routes.get("/auth/sso/callback")
    async def sso_callback(request):
        provider = _sso_provider_or_error(request)
        q = request.rel_url.query
        state = q.get("state")
        if not sso_states.redeem(state):
            return web.json_response(
                {"error": "invalid or expired SSO state"}, status=403
            )
        if request.cookies.get("px_sso_state") != state:
            return web.json_response(
                {"error": "SSO state does not match this browser's login"},
                status=403,
            )
        code = q.get("code")
        if not code:
            return web.json_response({"error": "missing code"}, status=400)
        try:
            username = await authenticate(
                provider,
                code=code,
                client_id=orch.conf.get("sso.client_id"),
                client_secret=orch.conf.get("sso.client_secret") or "",
                redirect_uri=_sso_redirect_uri(request),
            )
        except SSOError as e:
            return web.json_response({"error": str(e)}, status=502)
        # Provisioning gate: a verified provider identity is NOT platform
        # membership — on a public provider that would open the door to
        # every account there.  Existing same-provider users log in;
        # everyone else needs the allowlist (or the explicit auto_create
        # opt-in).
        existing = reg.get_user(username)
        is_returning = (
            existing is not None
            and existing.get("sso_provider") == provider.name
        )
        allowed = {
            u.strip()
            for u in (orch.conf.get("sso.allowed_users") or "").split(",")
            if u.strip()
        }
        if not is_returning and username not in allowed and not orch.conf.get(
            "sso.auto_create"
        ):
            return web.json_response(
                {
                    "error": f"{provider.name} user {username!r} is not "
                    "authorized for this platform (ask an admin to add you "
                    "to sso.allowed_users)"
                },
                status=403,
            )
        try:
            user, token = reg.ensure_sso_user(provider.name, username)
        except PolyaxonTPUError as e:
            # A colliding local/foreign-provider account: never taken over.
            return web.json_response({"error": str(e)}, status=409)
        if user.get("created"):
            orch.auditor.record(
                EventTypes.USER_CREATED, username=username, sso=provider.name
            )
        resp = web.Response(
            text=CALLBACK_HTML.format(token=token), content_type="text/html"
        )
        resp.del_cookie("px_sso_state")
        return resp

    @web.middleware
    async def auth_middleware(request, handler):
        # "/" (the static dashboard shell — no data in it), the health
        # endpoint, and the SSO entry/callback (the way IN) stay open; the
        # dashboard's API fetches carry the bearer token from
        # localStorage.  Auth is required when a bootstrap token is
        # configured OR any user exists (checked per request — users can
        # be minted at runtime).
        open_paths = ("/", f"{API_PREFIX}/status")
        required = bool(auth_token) or reg.has_users()
        request["auth_required"] = required
        if request.path.startswith("/auth/sso/"):
            request["actor"], request["role"] = None, None
            return await handler(request)
        if required and request.path not in open_paths:
            resolved = _resolve_actor(request)
            if resolved is None:
                return web.json_response({"error": "unauthorized"}, status=401)
            request["actor"], request["role"] = resolved
        elif required:
            # Open path under auth (probes): identity unknown, no powers.
            request["actor"], request["role"] = None, None
        else:
            # Open mode (dev/tests): every caller is the anonymous admin.
            request["actor"], request["role"] = "anonymous", "admin"
        return await handler(request)

    @web.middleware
    async def telemetry_middleware(request, handler):
        # Per-endpoint API latency keyed by the ROUTE TEMPLATE
        # (``/api/v1/runs/{run_id}``), never the resolved path — raw run
        # ids in a label would grow one series per run.  WS upgrades are
        # excluded from the latency histogram (a tail handler's "latency"
        # is the session length, which would swamp the REST p99); they
        # carry their own ws_tail_* series instead.
        stats = orch.stats
        if request.path.startswith("/ws/"):
            return await handler(request)
        t0 = time.perf_counter()
        code = 500
        try:
            resp = await handler(request)
            code = resp.status
            return resp
        except web.HTTPException as e:
            code = e.status
            raise
        finally:
            resource = getattr(request.match_info.route, "resource", None)
            canonical = getattr(resource, "canonical", None)
            route = canonical if canonical else "unmatched"
            elapsed = time.perf_counter() - t0
            stats.observe(
                labeled_key("api_request_s", method=request.method, route=route),
                elapsed,
            )
            stats.incr(
                labeled_key(
                    "api_request_total",
                    code=_STATUS_CLASSES.get(code // 100, "other"),
                    method=request.method,
                    route=route,
                )
            )

    app = web.Application(middlewares=[telemetry_middleware, auth_middleware])
    app.add_routes(routes)
    app["orchestrator"] = orch
    return app


def serve(
    base_dir: str,
    host: str = "127.0.0.1",
    port: int = 8000,
    orch: Optional[Orchestrator] = None,
    auth_token: Optional[str] = None,
) -> None:
    """Run the service: orchestrator loop in a thread + aiohttp in the main loop."""
    from aiohttp import web

    orch = orch or Orchestrator(base_dir)
    orch.start()
    app = create_app(
        orch, auth_token=auth_token or knob_str("POLYAXON_TPU_AUTH_TOKEN") or None
    )
    try:
        web.run_app(app, host=host, port=port, print=logger.info)
    finally:
        orch.stop()
