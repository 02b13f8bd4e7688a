"""Run a reference test of the API or the CLI on both planes and compare.

A reference test module (``tests/test_api/*.py``, ``tests/test_cli/test_main.py``)
drives the JAX package's ``create_app`` / ``main`` over the JAX
``Orchestrator``.  :func:`plane_module` gives it as written (the ``jax``
plane) and as the same source with every ``polyaxon_tpu`` name replaced by
``polyaxon_tpu_torch`` (the ``port`` plane): the port's app and CLI over the
port's ``Orchestrator``, with the port's builtin trainers as entry points.

:func:`run_both` runs one test of such a module on each plane, the
reference's own assertions included, and records what its client saw: every
HTTP response (status, JSON or text), every WebSocket frame, and every
``capsys.readouterr()`` of the CLI.  The two records must be equal after
:func:`mask` has replaced what differs from run to run (uuids, times,
durations, ports, the planes' directories, the entry point's package name)
and the one stated departure of the port: a run stored with a spec naming no
accelerator carries the card's topology (``h100``) where the reference
stores the schema's ``cpu``.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import io
import json
import re
import sys
import types
from collections import namedtuple
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
_PACKAGE = {"jax": "polyaxon_tpu", "port": "polyaxon_tpu_torch"}
_MODULES: Dict[Tuple[str, str], types.ModuleType] = {}


def plane_module(ref: str, plane: str) -> types.ModuleType:
    """The reference test module ``ref`` (a path under ``tests/``) on
    ``plane`` (``"jax"`` or ``"port"``)."""
    key = (ref, plane)
    if key not in _MODULES:
        name = "tests." + ref[len("tests/"):-len(".py")].replace("/", ".")
        if plane == "jax":
            mod = importlib.import_module(name)
        else:
            path = ROOT / ref
            source = re.sub(r"\bpolyaxon_tpu\b", "polyaxon_tpu_torch", path.read_text())
            mod = types.ModuleType(name + "__port")
            mod.__file__ = str(path)
            sys.modules[mod.__name__] = mod
            exec(compile(source, str(path), "exec"), mod.__dict__)
        _MODULES[key] = mod
    return _MODULES[key]


def cases(ref: str) -> List[str]:
    """The qualified names of ``ref``'s tests, in source order."""
    mod = plane_module(ref, "jax")
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("test") and inspect.isfunction(obj):
            out.append(name)
        elif name.startswith("Test") and inspect.isclass(obj):
            out += [f"{name}.{m}" for m, f in vars(obj).items()
                    if m.startswith("test") and inspect.isfunction(f)]
    return out


# -- recording ------------------------------------------------------------------

class Recorder:
    """What one plane's run of a test saw, in order."""

    def __init__(self) -> None:
        self.entries: List[Tuple] = []

    def add(self, *entry) -> None:
        self.entries.append(entry)


def _recording_client(recorder: Recorder):
    from aiohttp import test_utils

    class RecordingClient(test_utils.TestClient):
        async def _request(self, method, path, **kwargs):
            resp = await super()._request(method, path, **kwargs)
            body = await resp.read()
            key = (method, str(path), json.dumps(kwargs.get("json"), sort_keys=True, default=str),
                   json.dumps(kwargs.get("params"), sort_keys=True, default=str),
                   _auth(kwargs.get("headers")))
            recorder.add("http", key, resp.status, _body(resp, body))
            return resp

        async def ws_connect(self, path, **kwargs):
            ws = await super().ws_connect(path, **kwargs)
            receive = ws.receive

            async def recorded(*args, **kw):
                msg = await receive(*args, **kw)
                recorder.add("ws", str(path), int(msg.type), _frame(msg.data))
                return msg

            ws.receive = recorded
            return ws

    return RecordingClient


def _auth(headers) -> Optional[str]:
    if not headers:
        return None
    return str(dict(headers).get("Authorization"))  # masked with the rest


def _body(resp, body: bytes):
    ctype = resp.headers.get("Content-Type", "")
    if "json" in ctype:
        try:
            return json.loads(body)
        except ValueError:
            pass
    text = body.decode("utf-8", "replace")
    if "version=0.0.4" in ctype or "openmetrics" in ctype:
        # The exposition's values vary from run to run; its names do not.
        return {"metric_names": sorted(set(re.findall(r"^# TYPE (\S+)", text, re.M)))}
    try:  # JSON lines (a run's report file) compare row by row
        return {"jsonl": [json.loads(line) for line in text.splitlines() if line]}
    except ValueError:
        return text


def _frame(data):
    if isinstance(data, str):
        try:
            return json.loads(data)
        except ValueError:
            return data
    return data if data is None or isinstance(data, (int, float)) else repr(data)


class _Capsys:
    """``capsys`` for a test run outside pytest's capture: stdout and stderr
    redirected into buffers; each ``readouterr()`` is recorded."""

    Result = namedtuple("CaptureResult", "out err")

    def __init__(self, recorder: Recorder) -> None:
        self.recorder = recorder
        self._out, self._err = io.StringIO(), io.StringIO()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(contextlib.redirect_stdout(self._out))
        self._stack.enter_context(contextlib.redirect_stderr(self._err))

    def readouterr(self):
        out, err = self._out.getvalue(), self._err.getvalue()
        self._out.seek(0), self._out.truncate()
        self._err.seek(0), self._err.truncate()
        self.recorder.add("capsys", out, err)
        return self.Result(out, err)

    def close(self) -> None:
        self.readouterr()
        self._stack.close()


# -- running one plane ----------------------------------------------------------

def _fixture_function(obj) -> Optional[Callable]:
    wrapped = getattr(obj, "_get_wrapped_function", None)
    return wrapped() if wrapped is not None else None


def run_plane(ref: str, qualname: str, plane: str, tmp_path: Path) -> Recorder:
    """Run test ``qualname`` of ``ref`` on ``plane`` with fresh fixtures under
    ``tmp_path``; return what it saw.  A skip inside the test propagates."""
    from aiohttp import test_utils

    mod = plane_module(ref, plane)
    owner, _, fname = qualname.rpartition(".")
    fn = getattr(getattr(mod, owner)(), fname) if owner else getattr(mod, fname)
    recorder = Recorder()
    tmp_path.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as stack:
        values: Dict[str, Any] = {}

        def resolve(name: str):
            if name in values:
                return values[name]
            if name == "tmp_path":
                value = tmp_path
            elif name == "monkeypatch":
                mp = pytest.MonkeyPatch()
                stack.callback(mp.undo)
                value = mp
            elif name == "tmp_registry":
                registry = importlib.import_module(f"{_PACKAGE[plane]}.db.registry")
                value = registry.RunRegistry(tmp_path / "registry.db")
                stack.callback(value.close)
            elif name == "capsys":
                cap = _Capsys(recorder)
                stack.callback(cap.close)
                value = cap
            else:
                func = _fixture_function(getattr(mod, name, None))
                if func is None:
                    raise LookupError(f"no fixture {name!r} for {ref}::{qualname}")
                args = [resolve(p) for p in inspect.signature(func).parameters]
                out = func(*args)
                if inspect.isgenerator(out):
                    value = next(out)
                    stack.callback(_finish, out)
                else:
                    value = out
            values[name] = value
            return value

        args = {p: resolve(p) for p in inspect.signature(fn).parameters}
        real = test_utils.TestClient
        test_utils.TestClient = _recording_client(recorder)
        stack.callback(setattr, test_utils, "TestClient", real)
        fn(**args)
    return recorder


def _finish(gen) -> None:
    for _ in gen:
        pass


# -- comparing -------------------------------------------------------------------

_UUID = re.compile(r"\b[0-9a-f]{32}\b")
_HOSTPORT = re.compile(r"(127\.0\.0\.1|localhost):\d+")
#: A platform token (40 hex digits), an OAuth state, a Unix time in text.
_TOKEN = re.compile(r"\b[0-9a-f]{40}\b")
_STATE = re.compile(r"([?&]state=)[^&\s'\"]+")
_EPOCH = re.compile(r"\b1[0-9]{9}(\.[0-9]+)?\b")
_NUMBER_KEYS = re.compile(
    r"(^|_)(at|ts|time|times|dur|duration|start|end|elapsed|wall|s|ms|ns|age|since|uptime"
    r"|seconds|pid"
    r"|offset|size|bytes|mtime|rss|cpu|percent|latency|rate|throughput|eta)$"
    r"|_at$|_s$|_ms$|_ts$|_sec$|^created|^updated|^started|^finished|^last_seen")
#: Keys whose values vary from run to run however they are named.
_VOLATILE = {"uuid", "token", "state", "code", "nonce", "traceparent", "trace_id", "span_id",
             "hostname", "host", "pid", "pids", "secret_key", "key_id"}


def mask(value: Any, base: str) -> Any:
    """``value`` with what varies from run to run replaced by placeholders:
    uuids, hosts and ports, ``base`` (the plane's directory), timestamps and
    durations, and the port's package name (the reference's in its place)."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            key = str(k)
            if key in _VOLATILE and isinstance(v, (str, int)) and not isinstance(v, bool):
                out[key] = "<volatile>"
            elif isinstance(v, (int, float)) and not isinstance(v, bool) and _NUMBER_KEYS.search(key):
                out[key] = "<number>"
            else:
                out[mask(key, base) if isinstance(k, str) else k] = mask(v, base)
        return out
    if isinstance(value, (list, tuple)):
        return [mask(v, base) for v in value]
    if isinstance(value, str):
        value = value.replace(base, "<base>").replace("polyaxon_tpu_torch", "polyaxon_tpu")
        value = _HOSTPORT.sub("<host>", _UUID.sub("<uuid>", _TOKEN.sub("<token>", value)))
        value = _STATE.sub(r"\1<state>", _EPOCH.sub("<epoch>", value))
        value = re.sub(r"(File \"[^\"]+\", line )\d+", r"\1<n>", value)
        return re.sub(r"\d+\.\d+s\b", "<secs>", value)
    return value


#: The port's stated departures in text the API returns, each as the port's
#: text and the reference's in its place (ROADMAP.md, Queue 1, item 6).
DEPARTURES = (
    # checks/health.py:check_compile_cache: the port keeps no compile cache.
    ("this process: the port keeps no persistent compile cache (CUDA graphs are captured "
     "again at each start)", "this process: not enabled in this process"),
    # conf/options.py: the coordinator port range serves torch.distributed.
    ("512-wide torch.distributed coordinator", "512-wide jax.distributed coordinator"),
    # checks/health.py:check_static_analysis: with no lint state it names the
    # port's own lint (the package name is already masked to the reference's).
    ("run `python -m polyaxon_tpu.analysis`)",
     "run `python -m polyaxon_tpu.analysis` or `make lint`)"),
)

#: A stored topology where the spec named no accelerator, on each plane: the
#: reference stores the schema's default (``cpu``, 8 devices), the port one
#: card.  This is the port's one stated departure in what the API returns.
_DEFAULT_STORED = {"jax": {"accelerator": "cpu", "num_devices": 8, "num_hosts": 1},
                   "port": {"accelerator": "h100", "num_devices": 1, "num_hosts": 1}}


def stored_topology_departure(value: Any, plane: str) -> Any:
    """``value`` with each stored topology of a spec naming no accelerator
    replaced by a placeholder (:data:`_DEFAULT_STORED`)."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if k == "topology" and isinstance(v, dict) and all(
                    v.get(key) == want for key, want in _DEFAULT_STORED[plane].items()):
                out[k] = "<stored default topology>"
            else:
                out[k] = stored_topology_departure(v, plane)
        return out
    if isinstance(value, list):
        return [stored_topology_departure(v, plane) for v in value]
    return value


def _timing(value: Any) -> Any:
    """``value`` without what depends on timing rather than on the code, on
    either plane: a status history's ``running`` row (a gang that exits
    between two monitor polls is never seen running); a report file's
    heartbeat rows (periodic beats, as many as the run's wall holds); the
    order and ids of a run's anomaly rows (its gang-level and process-level
    detectors fire in either order)."""
    if isinstance(value, dict):
        return {k: _timing(v) for k, v in value.items()}
    if not isinstance(value, list):
        return value
    rows = [_timing(v) for v in value
            if not (isinstance(v, dict) and set(v) == {"status", "message", "created_at"}
                    and v["status"] == "running")
            and not (isinstance(v, dict) and v.get("type") == "heartbeat" and set(v) <= {
                "type", "ts"})]
    if rows and all(isinstance(r, dict) and {"kind", "process_id", "message", "attrs"} <= set(r)
                    for r in rows):
        rows = sorted(({k: v for k, v in r.items() if k != "id"} for r in rows),
                      key=lambda r: (str(r["process_id"]), r["kind"], str(r["message"])))
    return rows


def settled(entries: List[Tuple]) -> List[Tuple]:
    """The entries with polls collapsed: between two writes (a request that is
    not a GET, or a CLI call), a GET repeated to the same URL keeps only its
    last response, at its last place."""
    out: List[Tuple] = []
    epoch_reads: Dict[Tuple, int] = {}
    for entry in entries:
        if entry[0] == "http" and entry[1][0] == "GET":
            if entry[1] in epoch_reads:
                out[epoch_reads[entry[1]]] = None
            epoch_reads[entry[1]] = len(out)
        elif entry[0] != "ws":
            epoch_reads = {}
        out.append(entry)
    return [e for e in out if e is not None]


def _departures(value: Any) -> Any:
    if isinstance(value, dict):
        return {k: _departures(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_departures(v) for v in value]
    if isinstance(value, str):
        for port, reference in DEPARTURES:
            value = value.replace(port, reference)
    return value


def _printed(entry: Tuple) -> Tuple:
    """A CLI's captured output as compared: JSON it printed parsed; of the
    ``[status]`` lines that ``--watch`` prints as its polls see them, the
    last (the run's final status); of the ``statuses`` listing, every row
    but ``running`` (:func:`_timing`)."""
    _, out, err = entry
    try:
        out = json.loads(out)
    except ValueError:
        out = [line for line in out.splitlines() if not re.fullmatch(r"\S+  running", line)]
    lines = err.splitlines()
    status = [i for i, line in enumerate(lines) if line.startswith("[status] ")]
    err = [line for i, line in enumerate(lines) if i not in status[:-1]]
    return ("capsys", out, err)


def comparable(recorder: Recorder, base: Path, plane: str) -> List[Tuple]:
    out = [_timing(stored_topology_departure(mask(list(e), str(base)), plane))
           for e in settled([_printed(e) if e[0] == "capsys" else e for e in recorder.entries])]
    return [_departures(e) for e in out] if plane == "port" else out


def run_both(ref: str, qualname: str, tmp_path: Path) -> None:
    """Run the test on the JAX plane, then on the port; each must pass the
    reference's assertions, and the two records must be equal."""
    got = {}
    for plane in ("jax", "port"):
        base = tmp_path / plane
        got[plane] = comparable(run_plane(ref, qualname, plane, base), base, plane)
    assert len(got["port"]) == len(got["jax"]), _diff(got)
    for i, (port, jax) in enumerate(zip(got["port"], got["jax"])):
        assert port == jax, f"entry {i} {jax[:2]}: {_first_difference(port, jax)}"


def _first_difference(port, jax, where="") -> str:
    if isinstance(port, dict) and isinstance(jax, dict):
        for k in list(jax) + [k for k in port if k not in jax]:
            if port.get(k, "<missing>") != jax.get(k, "<missing>"):
                return _first_difference(port.get(k, "<missing>"), jax.get(k, "<missing>"),
                                         f"{where}.{k}")
    if isinstance(port, list) and isinstance(jax, list) and len(port) == len(jax):
        for i, (p, j) in enumerate(zip(port, jax)):
            if p != j:
                return _first_difference(p, j, f"{where}[{i}]")
    return f"at {where or '<top>'}:\nport {str(port)[:1500]}\njax  {str(jax)[:1500]}"


def _diff(got) -> str:
    lines = []
    for plane in ("jax", "port"):
        lines.append(f"{plane}: " + " | ".join(str(e[:2])[:120] for e in got[plane]))
    return "\n".join(lines)
