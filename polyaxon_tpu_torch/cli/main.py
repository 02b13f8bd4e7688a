"""The ``polyaxon-tpu-torch`` CLI: the port's copy of ``polyaxon_tpu/cli/main.py``.

The same subcommands over the port's ``Orchestrator`` (local mode) or the
port's ``serve`` (remote mode).  Departures from the reference: ``pools``
refuses with a message (the port has no TPU-VM provisioner), ``--version``
reads ``polyaxon_tpu_torch.__version__``, and the ``init`` starters name the
port's builtins on one card (``h100``).

Parity: the reference's external ``polyaxon-cli`` (run/init/logs/stop over
REST+WS, SURVEY §1 layer 1).  Two modes:

- **local** (default): embed the orchestrator over ``--base-dir`` and drive
  it in-process — no server needed, the dev/test workflow.
- **remote** (``--host``): talk to a running ``polyaxon-tpu-torch serve`` API.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from pathlib import Path
from typing import Any, Dict, Optional

from polyaxon_tpu_torch.conf.knobs import knob_str

DEFAULT_BASE = knob_str("POLYAXON_TPU_HOME")
AUTH_FILE = Path(DEFAULT_BASE).expanduser() / "auth.json"


def _stored_auth() -> dict:
    try:
        return json.loads(AUTH_FILE.read_text())
    except (OSError, ValueError):
        return {}


#: A down/hung control plane must error the CLI, not freeze the terminal.
#: Generous enough for slow artifact streams; connect failures surface in
#: seconds regardless.
_REQUEST_TIMEOUT_S = 60.0


class RemoteClient:
    """Thin urllib client for the REST API (no extra deps in the CLI path)."""

    def __init__(self, host: str, token: Optional[str] = None) -> None:
        self.base = host.rstrip("/")
        if not self.base.startswith("http"):
            self.base = f"http://{self.base}"
        # Priority: explicit flag > env > `polyaxon-tpu login` stored auth.
        stored = _stored_auth()
        self.token = (
            token
            or knob_str("POLYAXON_TPU_AUTH_TOKEN")
            or (stored.get("token") if stored.get("host") in (host, self.base) else None)
        )

    def _request(self, method: str, path: str, body: Optional[dict] = None) -> Any:
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            f"{self.base}{path}",
            method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers=headers,
        )
        with urllib.request.urlopen(req, timeout=_REQUEST_TIMEOUT_S) as resp:
            return json.loads(resp.read() or "{}")

    def submit(self, spec, project, name, tags):
        return self._request(
            "POST",
            "/api/v1/runs",
            {"spec": spec, "project": project, "name": name, "tags": tags},
        )

    def list(self, **query):
        from urllib.parse import urlencode

        qs = urlencode({k: v for k, v in query.items() if v is not None})
        return self._request("GET", f"/api/v1/runs?{qs}")["results"]

    def get(self, run_id):
        return self._request("GET", f"/api/v1/runs/{run_id}")

    def stop(self, run_id):
        return self._request("POST", f"/api/v1/runs/{run_id}/stop")

    def clone(self, run_id, strategy):
        return self._request("POST", f"/api/v1/runs/{run_id}/{strategy}")

    def archive(self, run_id):
        return self._request("POST", f"/api/v1/runs/{run_id}/archive")

    def restore(self, run_id):
        return self._request("POST", f"/api/v1/runs/{run_id}/restore")

    def delete(self, run_id):
        return self._request("DELETE", f"/api/v1/runs/{run_id}")

    def list_archives(self):
        return self._request("GET", "/api/v1/archives")["results"]

    def logs(self, run_id, since_id=0):
        return self._request(
            "GET", f"/api/v1/runs/{run_id}/logs?since_id={since_id}"
        )["results"]

    def statuses(self, run_id):
        return self._request("GET", f"/api/v1/runs/{run_id}/statuses")["results"]

    def list_devices(self):
        return self._request("GET", "/api/v1/devices")["results"]

    def register_device(self, name, accelerator, chips, num_hosts):
        return self._request(
            "POST",
            "/api/v1/devices",
            {
                "name": name,
                "accelerator": accelerator,
                "chips": chips,
                "num_hosts": num_hosts,
            },
        )

    def remove_device(self, name):
        return self._request("DELETE", f"/api/v1/devices/{name}")

    def list_artifacts(self, run_id):
        return self._request("GET", f"/api/v1/runs/{run_id}/artifacts")["results"]

    def create_user(self, username, role):
        return self._request(
            "POST", "/api/v1/users", {"username": username, "role": role}
        )

    def list_options(self):
        return self._request("GET", "/api/v1/options")["results"]

    def set_option(self, key, value):
        return self._request("PUT", f"/api/v1/options/{key}", {"value": value})

    def list_users(self):
        return self._request("GET", "/api/v1/users")["results"]

    def remove_user(self, username):
        return self._request("DELETE", f"/api/v1/users/{username}")

    def create_search(self, name, query):
        return self._request("POST", "/api/v1/searches", {"name": name, "query": query})

    def list_searches(self):
        return self._request("GET", "/api/v1/searches")["results"]

    def delete_search(self, name):
        return self._request("DELETE", f"/api/v1/searches/{name}")

    def execute_search(self, name):
        return self._request("GET", f"/api/v1/searches/{name}/runs")["results"]

    def create_project(self, name, description, owner=None):
        body = {"name": name, "description": description}
        if owner is not None:
            body["owner"] = owner
        return self._request("POST", "/api/v1/projects", body)

    def list_projects(self):
        return self._request("GET", "/api/v1/projects")["results"]

    def delete_project(self, name):
        return self._request("DELETE", f"/api/v1/projects/{name}")

    def set_ci(self, project, spec):
        return self._request("PUT", f"/api/v1/projects/{project}/ci", {"spec": spec})

    def get_ci(self, project):
        return self._request("GET", f"/api/v1/projects/{project}/ci")

    def delete_ci(self, project):
        return self._request("DELETE", f"/api/v1/projects/{project}/ci")

    def trigger_ci(self, project, context=None):
        body = {"context": context} if context else {}
        return self._request(
            "POST", f"/api/v1/projects/{project}/ci/trigger", body
        )

    def share_project(self, name, username):
        return self._request(
            "POST", f"/api/v1/projects/{name}/collaborators", {"username": username}
        )

    def unshare_project(self, name, username):
        return self._request(
            "DELETE", f"/api/v1/projects/{name}/collaborators/{username}"
        )

    def add_bookmark(self, run_id):
        return self._request("POST", f"/api/v1/runs/{run_id}/bookmark")

    def remove_bookmark(self, run_id):
        return self._request("DELETE", f"/api/v1/runs/{run_id}/bookmark")

    def list_bookmarks(self):
        return self._request("GET", "/api/v1/bookmarks")["results"]

    def open_artifact(self, run_id, key):
        """A readable stream over the artifact (caller closes)."""
        from urllib.parse import quote

        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            f"{self.base}/api/v1/runs/{run_id}/artifacts/{quote(key)}",
            headers=headers,
        )
        return urllib.request.urlopen(req, timeout=_REQUEST_TIMEOUT_S)


class LocalClient:
    """Embedded-orchestrator backend (creates it lazily, pumps eagerly)."""

    def __init__(self, base_dir: str, recover: bool = False) -> None:
        from polyaxon_tpu_torch.api.app import run_to_dict
        from polyaxon_tpu_torch.orchestrator import Orchestrator

        self._to_dict = run_to_dict
        self.orch = Orchestrator(Path(base_dir).expanduser())
        # Each CLI invocation is a fresh control plane over the same durable
        # registry. Commands that intentionally drive work (run/stop/clones,
        # logs --follow) re-enqueue dispatch tasks the previous process took
        # with it; pure reads (ps/get/statuses/...) must NOT — recovery has
        # write side effects (re-dispatch, process-row cleanup) that would
        # turn `ps` into an unmonitored gang launcher.
        if recover:
            self.orch.recover()

    def submit(self, spec, project, name, tags):
        run = self.orch.submit(spec, project=project, name=name, tags=tags)
        return self._to_dict(run)

    def list(self, **query):
        from polyaxon_tpu_torch.query import apply_query, filters_archived, parse_query

        conds = parse_query(query.get("q"))
        runs = self.orch.registry.list_runs(
            project=query.get("project"),
            kind=query.get("kind"),
            # A query on `archived:` owns that dimension (else its clause
            # would contradict the live-only default and match nothing).
            archived=None if filters_archived(conds) else False,
        )
        if conds:
            runs = apply_query(runs, conditions=conds)
        return [self._to_dict(r) for r in runs[: int(query.get("limit") or 100)]]

    def get(self, run_id):
        self.orch.pump()
        return self._to_dict(self.orch.get_run(int(run_id)))

    def stop(self, run_id):
        self.orch.stop_run(int(run_id))
        self.orch.pump(max_wait=1.0)
        return {"ok": True}

    def clone(self, run_id, strategy):
        return self._to_dict(self.orch.clone_run(int(run_id), strategy=strategy))

    def archive(self, run_id):
        self.orch.archive_run(int(run_id))
        self.orch.pump(max_wait=1.0)
        return self._to_dict(self.orch.get_run(int(run_id)))

    def restore(self, run_id):
        self.orch.restore_run(int(run_id))
        return self._to_dict(self.orch.get_run(int(run_id)))

    def delete(self, run_id):
        deleted = self.orch.delete_run(int(run_id))
        return {"ok": True, "deleted": deleted}

    def list_archives(self):
        return [
            self._to_dict(r)
            for r in self.orch.registry.list_runs(archived=True)
        ]

    def logs(self, run_id, since_id=0):
        self.orch.pump()
        return self.orch.registry.get_logs(int(run_id), since_id=since_id)

    def statuses(self, run_id):
        self.orch.pump()
        return self.orch.registry.get_statuses(int(run_id))

    def list_devices(self):
        return self.orch.registry.list_devices()

    def register_device(self, name, accelerator, chips, num_hosts):
        return self.orch.register_device(name, accelerator, chips, num_hosts=num_hosts)

    def remove_device(self, name):
        if not self.orch.registry.remove_device(name):
            raise SystemExit(f"no device named {name!r}")
        return {"ok": True}

    def list_artifacts(self, run_id):
        return self.orch.list_artifacts(int(run_id))

    def create_user(self, username, role):
        user, token = self.orch.registry.create_user(username, role=role)
        return {**user, "token": token}

    def list_options(self):
        from polyaxon_tpu_torch.conf.options import options_payload

        return options_payload(self.orch.conf)

    def set_option(self, key, value):
        from polyaxon_tpu_torch.conf.options import display_value, option_by_key

        opt = option_by_key(key)
        if opt is None:
            raise SystemExit(f"unknown option {key!r}")
        try:
            self.orch.conf.set(key, value)
        except (TypeError, ValueError) as e:
            raise SystemExit(str(e))  # clean message, like the API's 400
        return {"key": key, "value": display_value(opt, self.orch.conf.get(key))}

    def list_users(self):
        return self.orch.registry.list_users()

    def remove_user(self, username):
        if not self.orch.registry.remove_user(username):
            raise SystemExit(f"no user named {username!r}")
        return {"ok": True}

    def create_search(self, name, query):
        from polyaxon_tpu_torch.query import compile_to_sql, parse_query

        # Field validation too (same as the API): a stored search must
        # never blow up at ps --search time.
        compile_to_sql(parse_query(query))
        return self.orch.registry.create_search(name, query)

    def list_searches(self):
        return self.orch.registry.list_searches()

    def delete_search(self, name):
        if not self.orch.registry.delete_search(name):
            raise SystemExit(f"no search named {name!r}")
        return {"ok": True}

    def execute_search(self, name):
        search = self.orch.registry.get_search(name)
        if search is None:
            raise SystemExit(f"no search named {name!r}")
        from polyaxon_tpu_torch.query import apply_query, filters_archived, parse_query

        conds = parse_query(search["query"])
        runs = apply_query(
            self.orch.registry.list_runs(
                archived=None if filters_archived(conds) else False
            ),
            conditions=conds,
        )
        return [self._to_dict(r) for r in runs]

    def create_project(self, name, description, owner=None):
        return self.orch.registry.create_project(
            name, description=description, owner=owner
        )

    def set_ci(self, project, spec):
        return self.orch.set_project_ci(project, spec)

    def get_ci(self, project):
        ci = self.orch.registry.get_project_ci(project)
        if ci is None:
            raise SystemExit(f"no CI configured for {project!r}")
        return ci

    def delete_ci(self, project):
        if not self.orch.delete_project_ci(project):
            raise SystemExit(f"no CI configured for {project!r}")
        return {"ok": True}

    def trigger_ci(self, project, context=None):
        run = self.orch.trigger_ci(project, context=context)
        self.orch.pump(max_wait=1.0)
        if run is None:
            return {"triggered": False}
        return {"triggered": True, "run": self._to_dict(run)}

    def share_project(self, name, username):
        if self.orch.registry.get_project(name) is None:
            raise SystemExit(f"no project named {name!r}")
        self.orch.registry.add_collaborator(name, username)
        return self.orch.registry.get_project(name)

    def unshare_project(self, name, username):
        if not self.orch.registry.remove_collaborator(name, username):
            raise SystemExit(f"{username!r} is not a collaborator on {name!r}")
        return {"ok": True}

    def list_projects(self):
        return self.orch.registry.list_projects()

    def delete_project(self, name):
        from polyaxon_tpu_torch.exceptions import PolyaxonTPUError

        try:
            removed = self.orch.delete_project(name)
        except PolyaxonTPUError as e:
            raise SystemExit(str(e))
        if not removed:
            raise SystemExit(f"no project named {name!r}")
        return {"ok": True}

    def add_bookmark(self, run_id):
        # Owner '' == anonymous — the same convention the API middleware
        # maps its open-mode actor to, so local and serve modes share
        # bookmarks on a common base dir.
        self.orch.registry.add_bookmark(int(run_id))
        return {"ok": True}

    def remove_bookmark(self, run_id):
        if not self.orch.registry.remove_bookmark(int(run_id)):
            raise SystemExit("not bookmarked")
        return {"ok": True}

    def list_bookmarks(self):
        return [self._to_dict(r) for r in self.orch.registry.list_bookmarked_runs()]

    def open_artifact(self, run_id, key):
        f = self.orch.open_artifact(int(run_id), key)
        if f is None:
            raise SystemExit(f"artifact {key!r} not found for run {run_id}")
        return f

    def pump(self, max_wait: float) -> None:
        self.orch.pump(max_wait=max_wait)

    def close(self) -> None:
        self.orch.stop()


#: The clone strategies (reference CloningStrategy, SURVEY §5) — one list
#: shared by the parser, the dispatch, and the recovery gate so a new
#: strategy can't ship with recovery silently missing.
CLONE_STRATEGIES = ("restart", "resume", "copy")

#: Local-mode commands that drive the task graph and therefore recover
#: stranded work on startup. `logs --follow` is included: following a run
#: started by a previous invocation requires reattaching its gang to make
#: progress (each CLI invocation is a fresh control plane).
_DRIVING_COMMANDS = {"run", "stop", "archive", "delete", *CLONE_STRATEGIES}


def _client(args):
    if args.host:
        return RemoteClient(args.host, token=getattr(args, "token", None))
    recover = args.command in _DRIVING_COMMANDS or (
        args.command == "logs" and getattr(args, "follow", False)
    ) or (
        args.command == "ci" and getattr(args, "ci_command", None) == "trigger"
    )
    return LocalClient(args.base_dir, recover=recover)


def _watch(client, run_id: int, poll: float = 0.5) -> str:
    seen_status = None
    log_cursor = 0
    while True:
        if isinstance(client, LocalClient):
            client.pump(max_wait=poll)
        run = client.get(run_id)
        if run["status"] != seen_status:
            seen_status = run["status"]
            print(f"[status] {seen_status}", file=sys.stderr)
        for row in client.logs(run_id, since_id=log_cursor):
            log_cursor = max(log_cursor, row["id"])
            prefix = f"p{row['process_id']}| " if row.get("process_id") is not None else ""
            print(f"{prefix}{row['line']}")
        if run["is_done"]:
            return run["status"]
        if not isinstance(client, LocalClient):
            time.sleep(poll)


def _print_runs(runs) -> None:
    fmt = "{:>5}  {:12}  {:10}  {:12}  {:}"
    print(fmt.format("ID", "KIND", "PROJECT", "STATUS", "NAME"))
    for r in runs:
        print(
            fmt.format(
                r["id"], r["kind"], r["project"][:10], r["status"], r["name"] or ""
            )
        )


#: `init` scaffolds (the reference's `polyaxon init` starter files), on one
#: card where the reference names a ``v5e-8`` slice.
_STARTERS = {
    "experiment": """kind: experiment
run:
  entrypoint: polyaxon_tpu_torch.builtins.trainers:lm_train
declarations:
  steps: 100
  batch: 8
  seq: 512
environment:
  seed: 42
  topology:
    accelerator: h100
    num_devices: 1
    num_hosts: 1
    strategy: fsdp
""",
    "group": """kind: group
run:
  entrypoint: polyaxon_tpu_torch.builtins.trainers:lm_train
declarations:
  steps: 100
hptuning:
  concurrency: 2
  matrix:
    lr: {values: [1.0e-4, 3.0e-4, 1.0e-3]}
environment:
  topology:
    accelerator: h100
    num_devices: 1
    num_hosts: 1
    strategy: ddp
""",
    "pipeline": """kind: pipeline
ops:
  - name: prepare
    run:
      entrypoint: polyaxon_tpu_torch.builtins.trainers:noop
    environment:
      topology: {accelerator: h100, num_devices: 1, num_hosts: 1}
  - name: train
    run:
      entrypoint: polyaxon_tpu_torch.builtins.trainers:lm_train
    environment:
      topology: {accelerator: h100, num_devices: 1, num_hosts: 1}
    dependencies: [prepare]
""",
    "tensorboard": """kind: tensorboard
declarations:
  target: <run-uuid>   # whose outputs to visualize
environment:
  topology:
    accelerator: cpu-1
    num_devices: 1
    num_hosts: 1
""",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="polyaxon-tpu-torch", description="TPU-native experiment platform CLI (the H100 port)"
    )
    from polyaxon_tpu_torch import __version__

    parser.add_argument(
        "--version", action="version", version=f"polyaxon-tpu-torch {__version__}"
    )
    parser.add_argument("--host", help="API server address (remote mode)")
    parser.add_argument(
        "--token", help="API bearer token (or POLYAXON_TPU_AUTH_TOKEN)"
    )
    parser.add_argument(
        "--base-dir", default=DEFAULT_BASE, help="platform state dir (local mode)"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_init = sub.add_parser("init", help="write a starter polyaxonfile")
    p_init.add_argument("-f", "--file", default="polyaxonfile.yml")
    p_init.add_argument(
        "--kind", default="experiment",
        choices=("experiment", "group", "pipeline", "tensorboard"),
    )

    p_run = sub.add_parser("run", help="submit a polyaxonfile")
    p_run.add_argument("-f", "--file", required=True, help="spec file (yaml/json)")
    p_run.add_argument("--project", default="default")
    p_run.add_argument("--name")
    p_run.add_argument("--tags", nargs="*")
    p_run.add_argument(
        "-w", "--watch", action="store_true", help="stream statuses/logs until done"
    )

    p_ps = sub.add_parser("ps", help="list runs")
    p_ps.add_argument("--project")
    p_ps.add_argument("--kind")
    p_ps.add_argument("--limit", type=int, default=50)
    p_ps.add_argument(
        "-q", "--query", help='filter DSL, e.g. "status:running,metric.loss:<0.5"'
    )
    p_ps.add_argument("--search", help="run a saved search by name")

    p_get = sub.add_parser("get", help="show one run as json")
    p_get.add_argument("run_id")

    p_logs = sub.add_parser("logs", help="print run logs")
    p_logs.add_argument("run_id")
    p_logs.add_argument("-f", "--follow", action="store_true")

    p_stop = sub.add_parser("stop", help="stop a run")
    p_stop.add_argument("run_id")

    p_archive = sub.add_parser(
        "archive", help="hide a run from listings (stops it if live)"
    )
    p_archive.add_argument("run_id")

    p_restore = sub.add_parser("restore", help="un-archive a run")
    p_restore.add_argument("run_id")

    p_delete = sub.add_parser(
        "delete", help="purge a run: rows, outputs, logs, store artifacts"
    )
    p_delete.add_argument("run_id")

    sub.add_parser("archives", help="list archived runs")

    for strategy in CLONE_STRATEGIES:
        p = sub.add_parser(strategy, help=f"{strategy} a run as a clone")
        p.add_argument("run_id")

    p_statuses = sub.add_parser("statuses", help="status history")
    p_statuses.add_argument("run_id")

    p_dev = sub.add_parser("devices", help="accelerator inventory (admission)")
    dev_sub = p_dev.add_subparsers(dest="devices_command", required=True)
    dev_sub.add_parser("list", help="show registered slices and holders")
    p_dev_add = dev_sub.add_parser("add", help="register a slice")
    p_dev_add.add_argument("name")
    p_dev_add.add_argument("--accelerator", required=True, help="e.g. v5e-8")
    p_dev_add.add_argument("--chips", type=int, required=True)
    p_dev_add.add_argument("--hosts", type=int, default=1)
    p_dev_rm = dev_sub.add_parser("remove", help="drop a slice")
    p_dev_rm.add_argument("name")

    p_pool = sub.add_parser(
        "pools", help="provision/teardown TPU-VM slices (refused: the port has no provisioner)"
    )
    pool_sub = p_pool.add_subparsers(dest="pools_command", required=True)
    p_pool_up = pool_sub.add_parser(
        "provision", help="create N slices, register them for admission + ssh"
    )
    p_pool_up.add_argument("prefix", help="slice name prefix ({prefix}-{i})")
    p_pool_up.add_argument("--count", type=int, default=1)
    p_pool_up.add_argument(
        "--type", required=True, dest="accelerator_type",
        help="accelerator type, e.g. v5litepod-16",
    )
    p_pool_up.add_argument("--version", help="tpu-vm image (default from conf)")
    p_pool_up.add_argument("--preemptible", action="store_true")
    pool_sub.add_parser("list", help="management-plane view joined with admission")
    p_pool_down = pool_sub.add_parser(
        "teardown", help="delete slices and unregister them"
    )
    p_pool_down.add_argument("names", nargs="+")

    p_data = sub.add_parser("data", help="store-resident datasets (local mode)")
    data_sub = p_data.add_subparsers(dest="data_command", required=True)
    data_sub.add_parser("ls", help="list registered datasets")
    p_data_cifar = data_sub.add_parser(
        "register-cifar10", help="register CIFAR-10 from the standard archive dir"
    )
    p_data_cifar.add_argument("batches_dir", help="path to cifar-10-batches-py")

    p_art = sub.add_parser("artifacts", help="browse/fetch run artifacts")
    art_sub = p_art.add_subparsers(dest="artifacts_command", required=True)
    p_art_ls = art_sub.add_parser("ls", help="list a run's artifact keys")
    p_art_ls.add_argument("run_id")
    p_art_pull = art_sub.add_parser("pull", help="download one artifact")
    p_art_pull.add_argument("run_id")
    p_art_pull.add_argument("key")
    p_art_pull.add_argument("-o", "--output", help="write here (default: stdout)")

    p_proj = sub.add_parser("projects", help="project metadata")
    proj_sub = p_proj.add_subparsers(dest="projects_command", required=True)
    p_proj_add = proj_sub.add_parser("add", help="register a project")
    p_proj_add.add_argument("name")
    p_proj_add.add_argument("--description")
    p_proj_add.add_argument(
        "--owner", help="scope access to this user (+collaborators/admins)"
    )
    proj_sub.add_parser("list", help="projects with run counts")
    p_proj_rm = proj_sub.add_parser("remove", help="delete an empty project")
    p_proj_rm.add_argument("name")
    p_proj_share = proj_sub.add_parser("share", help="add a collaborator")
    p_proj_share.add_argument("name")
    p_proj_share.add_argument("username")
    p_proj_unshare = proj_sub.add_parser("unshare", help="drop a collaborator")
    p_proj_unshare.add_argument("name")
    p_proj_unshare.add_argument("username")

    p_ci = sub.add_parser(
        "ci", help="per-project CI: run a spec on every new code snapshot"
    )
    ci_sub = p_ci.add_subparsers(dest="ci_command", required=True)
    p_ci_set = ci_sub.add_parser("set", help="enable/replace a project's CI spec")
    p_ci_set.add_argument("-f", "--file", required=True, help="polyaxonfile to run")
    p_ci_set.add_argument("-p", "--project", default="default")
    p_ci_show = ci_sub.add_parser("show", help="show a project's CI config")
    p_ci_show.add_argument("-p", "--project", default="default")
    p_ci_off = ci_sub.add_parser("off", help="disable a project's CI")
    p_ci_off.add_argument("-p", "--project", default="default")
    p_ci_trigger = ci_sub.add_parser(
        "trigger", help="snapshot a context dir and run CI if the code is new"
    )
    p_ci_trigger.add_argument("-p", "--project", default="default")
    p_ci_trigger.add_argument(
        "--context", help="directory to snapshot (default: the CI spec's build context)"
    )

    p_search = sub.add_parser("searches", help="saved run searches")
    search_sub = p_search.add_subparsers(dest="searches_command", required=True)
    p_search_add = search_sub.add_parser("add", help="save a query under a name")
    p_search_add.add_argument("name")
    p_search_add.add_argument("query")
    search_sub.add_parser("list", help="list saved searches")
    p_search_rm = search_sub.add_parser("remove", help="delete a saved search")
    p_search_rm.add_argument("name")

    p_bm = sub.add_parser("bookmark", help="bookmark a run")
    p_bm.add_argument("run_id")
    p_bm.add_argument("-d", "--delete", action="store_true", help="remove instead")
    sub.add_parser("bookmarks", help="list bookmarked runs")

    p_cfg = sub.add_parser("config", help="runtime-mutable platform options")
    cfg_sub = p_cfg.add_subparsers(dest="config_command", required=True)
    cfg_sub.add_parser("list", help="all options with resolved values")
    p_cfg_set = cfg_sub.add_parser("set", help="write an option to the DB store")
    p_cfg_set.add_argument("key")
    p_cfg_set.add_argument("value")

    p_login = sub.add_parser("login", help="store an API host + token")
    p_login.add_argument("--api-host", required=True, help="API server address")
    p_login.add_argument("--api-token", required=True, help="your user token")

    p_users = sub.add_parser("users", help="manage users (admin)")
    users_sub = p_users.add_subparsers(dest="users_command", required=True)
    p_users_add = users_sub.add_parser("add", help="create a user, print their token")
    p_users_add.add_argument("username")
    p_users_add.add_argument("--role", default="user", choices=("user", "admin"))
    users_sub.add_parser("list", help="list users")
    p_users_rm = users_sub.add_parser("remove", help="delete a user")
    p_users_rm.add_argument("username")

    p_serve = sub.add_parser("serve", help="run the API service")
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.add_argument("--bind", default="127.0.0.1")

    args = parser.parse_args(argv)

    if args.command == "login":
        host = args.api_host.rstrip("/")
        if not host.startswith("http"):
            host = f"http://{host}"  # the normalization RemoteClient applies
        AUTH_FILE.parent.mkdir(parents=True, exist_ok=True)
        # 0600 from birth — no window where the token is world-readable.
        import os as _os

        fd = _os.open(
            AUTH_FILE, _os.O_WRONLY | _os.O_CREAT | _os.O_TRUNC, 0o600
        )
        with _os.fdopen(fd, "w") as fh:
            fh.write(json.dumps({"host": host, "token": args.api_token}))
        print(f"stored credentials for {host} in {AUTH_FILE}", file=sys.stderr)
        return 0

    if args.command == "serve":
        from polyaxon_tpu_torch.api.app import serve

        serve(
            str(Path(args.base_dir).expanduser()),
            host=args.bind,
            port=args.port,
            auth_token=args.token,
        )
        return 0

    if args.command == "init":
        target = Path(args.file)
        try:
            # Exclusive create: refuses existing files atomically (no
            # exists()-then-write race).
            with target.open("x") as fh:
                fh.write(_STARTERS[args.kind])
        except FileExistsError:
            raise SystemExit(f"{target} already exists")
        print(f"wrote {target} ({args.kind})", file=sys.stderr)
        return 0

    client = _client(args)
    try:
        if args.command == "run":
            spec_text = Path(args.file).read_text()
            run = client.submit(spec_text, args.project, args.name, args.tags)
            print(f"Created run {run['id']} ({run['kind']})", file=sys.stderr)
            if args.watch:
                status = _watch(client, run["id"])
                return 0 if status == "succeeded" else 1
            print(json.dumps(run, indent=2, default=str))
            return 0
        if args.command == "ps":
            if args.search:
                _print_runs(client.execute_search(args.search))
            else:
                _print_runs(
                    client.list(
                        project=args.project,
                        kind=args.kind,
                        limit=args.limit,
                        q=args.query,
                    )
                )
            return 0
        if args.command == "get":
            print(json.dumps(client.get(args.run_id), indent=2, default=str))
            return 0
        if args.command == "logs":
            if args.follow:
                _watch(client, int(args.run_id))
            else:
                for row in client.logs(args.run_id):
                    print(row["line"])
            return 0
        if args.command == "stop":
            client.stop(args.run_id)
            print("stopped", file=sys.stderr)
            return 0
        if args.command == "archive":
            run = client.archive(args.run_id)
            print(f"archived run {run['id']}", file=sys.stderr)
            return 0
        if args.command == "restore":
            run = client.restore(args.run_id)
            print(f"restored run {run['id']}", file=sys.stderr)
            return 0
        if args.command == "delete":
            out = client.delete(args.run_id)
            print(
                f"deleted {out.get('deleted', 1)} run(s) and their data",
                file=sys.stderr,
            )
            return 0
        if args.command == "archives":
            _print_runs(client.list_archives())
            return 0
        if args.command in CLONE_STRATEGIES:
            clone = client.clone(args.run_id, args.command)
            print(json.dumps(clone, indent=2, default=str))
            return 0
        if args.command == "statuses":
            for s in client.statuses(args.run_id):
                msg = f"  {s['message']}" if s.get("message") else ""
                print(f"{s['created_at']:.1f}  {s['status']}{msg}")
            return 0
        if args.command == "data":
            if not isinstance(client, LocalClient):
                raise SystemExit("data commands run in local mode (datasets live in the store layout)")
            from polyaxon_tpu_torch.runtime.datasets import list_datasets, register_cifar10

            data_dir = client.orch.layout.data_dir
            if args.data_command == "ls":
                for d in list_datasets(data_dir):
                    print(
                        f"{d['name']:24} {d['num_examples']:>8} examples, "
                        f"{d['shards']} shards"
                    )
            elif args.data_command == "register-cifar10":
                out = register_cifar10(data_dir, args.batches_dir)
                for split, meta in out.items():
                    print(f"registered cifar10-{split}: {meta['num_examples']} examples")
            return 0
        if args.command == "artifacts":
            if args.artifacts_command == "ls":
                for key in client.list_artifacts(args.run_id):
                    print(key)
            elif args.artifacts_command == "pull":
                import shutil

                with client.open_artifact(args.run_id, args.key) as src:
                    if args.output:
                        with open(args.output, "wb") as dst:
                            shutil.copyfileobj(src, dst)
                        print(f"wrote {args.output}", file=sys.stderr)
                    else:
                        shutil.copyfileobj(src, sys.stdout.buffer)
            return 0
        if args.command == "projects":
            if args.projects_command == "add":
                print(json.dumps(client.create_project(
                    args.name, args.description, owner=args.owner
                )))
            elif args.projects_command == "list":
                fmt = "{:16}  {:>6}  {:10}  {:}"
                print(fmt.format("NAME", "RUNS", "OWNER", "DESCRIPTION"))
                for pr in client.list_projects():
                    print(fmt.format(
                        pr["name"], pr["num_runs"], pr.get("owner") or "-",
                        pr.get("description") or "",
                    ))
            elif args.projects_command == "remove":
                client.delete_project(args.name)
                print("removed", file=sys.stderr)
            elif args.projects_command == "share":
                print(json.dumps(client.share_project(args.name, args.username)))
            elif args.projects_command == "unshare":
                client.unshare_project(args.name, args.username)
                print("removed collaborator", file=sys.stderr)
            return 0
        if args.command == "ci":
            if args.ci_command == "set":
                spec_text = Path(args.file).read_text()
                import yaml

                ci = client.set_ci(args.project, yaml.safe_load(spec_text))
                print(json.dumps(ci, indent=2, default=str))
            elif args.ci_command == "show":
                print(json.dumps(client.get_ci(args.project), indent=2, default=str))
            elif args.ci_command == "off":
                client.delete_ci(args.project)
                print("CI disabled", file=sys.stderr)
            elif args.ci_command == "trigger":
                out = client.trigger_ci(args.project, context=args.context)
                if out.get("triggered"):
                    run = out["run"]
                    print(
                        f"CI triggered run {run['id']} ({run['kind']})",
                        file=sys.stderr,
                    )
                else:
                    print("code unchanged — nothing to run", file=sys.stderr)
            return 0
        if args.command == "searches":
            if args.searches_command == "add":
                print(json.dumps(client.create_search(args.name, args.query)))
            elif args.searches_command == "list":
                for sr in client.list_searches():
                    print(f"{sr['name']:20} {sr['query']}")
            elif args.searches_command == "remove":
                client.delete_search(args.name)
                print("removed", file=sys.stderr)
            return 0
        if args.command == "bookmark":
            if args.delete:
                client.remove_bookmark(args.run_id)
                print("unbookmarked", file=sys.stderr)
            else:
                client.add_bookmark(args.run_id)
                print("bookmarked", file=sys.stderr)
            return 0
        if args.command == "bookmarks":
            _print_runs(client.list_bookmarks())
            return 0
        if args.command == "config":
            if args.config_command == "list":
                fmt = "{:36}  {:18}  {:}"
                print(fmt.format("KEY", "VALUE", "DESCRIPTION"))
                for o in client.list_options():
                    print(fmt.format(o["key"], str(o["value"])[:18],
                                     o["description"][:60]))
            elif args.config_command == "set":
                out = client.set_option(args.key, args.value)
                print(json.dumps(out))
            return 0
        if args.command == "users":
            if args.users_command == "add":
                user = client.create_user(args.username, args.role)
                print(
                    f"user {user['username']} ({user['role']}) created; token "
                    "(shown once):",
                    file=sys.stderr,
                )
                print(user["token"])
            elif args.users_command == "list":
                fmt = "{:>4}  {:16}  {:6}  {:}"
                print(fmt.format("ID", "USERNAME", "ROLE", "LAST USED"))
                for u in client.list_users():
                    last = u.get("last_used_at")
                    print(
                        fmt.format(
                            u["id"], u["username"], u["role"],
                            f"{last:.0f}" if last else "-",
                        )
                    )
            elif args.users_command == "remove":
                client.remove_user(args.username)
                print("removed", file=sys.stderr)
            return 0
        if args.command == "pools":
            # The reference drives gcloud TPU-VM provisioning
            # (``spawner/provision.py``), which the port has no counterpart of.
            raise SystemExit(
                "pools: the port provisions no TPU-VM slices; register a host's cards "
                "with `devices add <name> --accelerator h100 --chips N` instead"
            )
        if args.command == "devices":
            if args.devices_command == "list":
                fmt = "{:>4}  {:16}  {:10}  {:>9}  {:>6}  {:}"
                print(fmt.format("ID", "NAME", "ACCEL", "CHIPS", "HOSTS", "HELD BY"))
                for d in client.list_devices():
                    used = d.get("used_chips", d["chips"] if d.get("run_id") else 0)
                    holders = d.get("holders") or (
                        [d["run_id"]] if d.get("run_id") else []
                    )
                    print(
                        fmt.format(
                            d["id"], d["name"], d["accelerator"],
                            f"{used}/{d['chips']}", d["num_hosts"],
                            ",".join(str(h) for h in holders) or "-",
                        )
                    )
            elif args.devices_command == "add":
                d = client.register_device(
                    args.name, args.accelerator, args.chips, args.hosts
                )
                print(json.dumps(d, indent=2, default=str))
            elif args.devices_command == "remove":
                client.remove_device(args.name)
                print("removed", file=sys.stderr)
            return 0
    finally:
        if isinstance(client, LocalClient):
            client.close()
    return 2


if __name__ == "__main__":
    sys.exit(main())
