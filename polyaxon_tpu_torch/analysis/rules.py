"""The graft-lint rule catalog, the port's copy of ``polyaxon_tpu/analysis/rules.py``.

Each rule guards a bug class of the platform; the rule ids are the
reference's, referenced from suppression comments:

- **GL001 capture-purity** — host syncs and host I/O inside code that is
  captured into a CUDA graph: a function handed to ``capture_step``
  (``models/decode.py``) or to ``torch.cuda.make_graphed_callables``, or
  the body of a ``with torch.cuda.graph(...)`` block.  ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``,
  ``np.asarray`` and ``float(arg)`` either break the capture or bake one
  host value into every replay; ``print``, ``open`` and ``time.*`` run at
  capture only, never at replay.
- **GL002 static-inputs** — a function that captures a graph must not, after
  the capture, rebind (``x = ...``) a name the captured code reads: every
  replay goes on reading the buffer that was captured.  The fix is a write
  in place (``x.copy_(...)``, ``x += 1`` on a tensor), as ``generate``'s
  decode loop does (``token.copy_(pick(logits))``, ``pos += 1``).
- **GL003 lock-discipline** — SQL writes outside ``with self._lock``
  in lock-carrying classes (the archival-walk bug class).
- **GL004 tick-path blocking** — blocking calls in beat hooks, command
  handlers, and bus tasks (these paths ride every heartbeat).
- **GL005 knob-registry** — every ``POLYAXON_TPU_*`` literal resolves
  to the ``conf/knobs.py`` catalog and vice versa (a typo'd knob used
  to silently no-op).
- **GL006 net-timeout** — network I/O anywhere without an explicit
  timeout.
- **GL007 metric-labels** — ``labeled_key`` label keys come from a
  closed catalog and label values are never built by interpolation
  (an unbounded identifier in a label mints one series per value).
- **GL008 span-names** — tracer span names are catalogued literals.

Departures from the reference.  GL001 and GL002 keep their ids but not
their meaning: the reference's look for ``jax.jit``, ``pjit``,
``shard_map`` and ``lax.scan`` (host syncs in a traced function;
undonated jit rebinds), which the port never calls, so copied as they
are they would check nothing.  The port's counterpart of a traced step is
a captured CUDA graph, and its counterpart of donation is buffer identity:
a captured step reads fixed addresses, so a rebound input is the stale
buffer the reference's donation rule guarded against.  GL005 reads the
port's catalog as it is shaped (``KNOBS``: a name to its default;
``FAMILIES``: a tuple of prefixes), in both directions.  GL003, GL004,
GL006, GL007 and GL008 are the reference's, with its messages and
catalogs.

All rules are heuristic *and lexical* — they see one module at a time
(GL004/GL005 add a project-wide index) and do not chase cross-module
call graphs.  That is the point: the invariants are local disciplines;
where code is legitimately outside a rule's shape, suppress with a
justification.
"""

from __future__ import annotations

import ast
import re as _re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from polyaxon_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Project,
    Rule,
    call_keywords,
    dotted_name,
)
from polyaxon_tpu_torch.conf.knobs import FAMILIES, KNOBS

__all__ = ["ALL_RULES", "default_rules", "rule_by_id"]


# ---------------------------------------------------------------------------
# GL001 — capture purity
# ---------------------------------------------------------------------------

#: Callables (matched on the dotted name's last part) whose first positional
#: argument, or ``fn=``, is run once into a CUDA graph and then replayed.
_CAPTURE_CALLS = {"capture_step"}
#: Callables whose first argument (a callable or a tuple of them) is graphed.
_GRAPHED_CALLS = {"torch.cuda.make_graphed_callables", "cuda.make_graphed_callables",
                  "make_graphed_callables"}
#: Context managers whose body is captured.
_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}

#: Dotted call names that force a host round-trip or host I/O.
_HOST_SYNC_PREFIXES = ("time.",)
_HOST_SYNC_CALLS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "torch.cuda.synchronize",
}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_SYNC_BUILTINS = {"print", "input", "open", "breakpoint"}


def _function_defs(tree: ast.AST) -> Dict[str, List[ast.FunctionDef]]:
    defs: Dict[str, List[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    return defs


def _param_names(fn: ast.AST) -> Set[str]:
    args = fn.args
    names = {a.arg for a in args.args + args.posonlyargs + args.kwonlyargs}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    return names


def _captured_target(node: ast.Call) -> Optional[ast.AST]:
    """The callable a ``capture_step`` call captures, or None."""
    if dotted_name(node.func).rsplit(".", 1)[-1] not in _CAPTURE_CALLS:
        return None
    if node.args:
        return node.args[0]
    return next((kw.value for kw in node.keywords if kw.arg == "fn"), None)


def _graph_context(node: ast.With) -> Optional[str]:
    """The dotted name of a ``with`` item that captures its body, or None."""
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and dotted_name(expr.func) in _GRAPH_CONTEXTS:
            return dotted_name(expr.func)
    return None


def _resolve(target: ast.AST, defs: Dict[str, List[ast.FunctionDef]]) -> List[ast.AST]:
    """A lambda, or the functions of the module with the name given."""
    if isinstance(target, ast.Lambda):
        return [target]
    if isinstance(target, ast.Name):
        return list(defs.get(target.id, ()))
    if isinstance(target, (ast.Tuple, ast.List)):
        return [fn for elt in target.elts for fn in _resolve(elt, defs)]
    return []


def _enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


class CapturePurityRule(Rule):
    id = "GL001"
    name = "capture-purity"
    version = "1"
    doc = (
        "functions captured into a CUDA graph (capture_step(fn), "
        "torch.cuda.make_graphed_callables(fn), a `with torch.cuda.graph(...)` "
        "body) must not contain host syncs (.item()/.tolist()/.cpu()/.numpy()/"
        "torch.cuda.synchronize/np.asarray/float(arg)), I/O (print/open), or "
        "time.* calls — a capture refuses a sync or bakes one host value "
        "into every replay, and host work runs at capture only"
    )

    def check_module(self, mod: ModuleInfo, project: Project):
        defs = _function_defs(mod.tree)
        seen: Set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.With):
                ctx = _graph_context(node)
                if ctx is not None:
                    fn = _enclosing_function(node)
                    where = f"the `{ctx}(...)` body in `{getattr(fn, 'name', '<module>')}`"
                    params = _param_names(fn) if fn is not None else set()
                    yield from self._scan(mod, node.body, params, where)
                continue
            if not isinstance(node, ast.Call):
                continue
            target = _captured_target(node)
            if target is None and dotted_name(node.func) in _GRAPHED_CALLS and node.args:
                target = node.args[0]
            if target is None:
                continue
            for fn in _resolve(target, defs):
                if id(fn) in seen:
                    continue
                seen.add(id(fn))
                body = fn.body if isinstance(fn.body, list) else [fn.body]
                where = f"captured function `{getattr(fn, 'name', '<lambda>')}`"
                yield from self._scan(mod, body, _param_names(fn), where)

    def _scan(self, mod: ModuleInfo, body: List[ast.AST], params: Set[str], where: str):
        for stmt in body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name in _HOST_SYNC_BUILTINS:
                    yield self.finding(
                        mod,
                        node,
                        f"host I/O `{name}(...)` inside {where} — it runs at "
                        "capture, never at replay",
                    )
                elif name in _HOST_SYNC_CALLS or any(
                    name.startswith(p) for p in _HOST_SYNC_PREFIXES
                ):
                    yield self.finding(
                        mod,
                        node,
                        f"host sync `{name}(...)` inside {where} — the capture "
                        "refuses it or bakes one host value into every replay",
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_SYNC_METHODS
                    and not node.args
                ):
                    yield self.finding(
                        mod,
                        node,
                        f"`.{node.func.attr}()` inside {where} — a "
                        "device-to-host wait the capture refuses",
                    )
                elif (
                    isinstance(node.func, ast.Name)
                    and node.func.id in ("float", "int", "bool")
                    and len(node.args) == 1
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in params
                ):
                    yield self.finding(
                        mod,
                        node,
                        f"`{node.func.id}({node.args[0].id})` on an argument "
                        f"of {where} — a host read of a device value (the "
                        "capture refuses it, or bakes it into every replay)",
                    )


# ---------------------------------------------------------------------------
# GL002 — static inputs of a captured graph
# ---------------------------------------------------------------------------

def _target_exprs(target: ast.AST) -> List[str]:
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(_target_exprs(elt))
        return out
    if isinstance(target, ast.Starred):
        return _target_exprs(target.value)
    name = dotted_name(target)
    return [name] if name else []


def _free_reads(body: List[ast.AST], bound: Set[str]) -> Set[str]:
    """Names and attribute chains (each with its prefixes) that ``body``
    loads and does not bind itself nor take in ``bound``."""
    nodes = [n for stmt in body for n in ast.walk(stmt)]
    local = set(bound)
    for n in nodes:
        if isinstance(n, ast.Name) and not isinstance(n.ctx, ast.Load):
            local.add(n.id)
    reads: Set[str] = set()
    for n in nodes:
        if not isinstance(n, (ast.Name, ast.Attribute)) or not isinstance(n.ctx, ast.Load):
            continue
        parts = dotted_name(n).split(".")
        if not parts[0] or parts[0] == "()" or parts[0] in local:
            continue
        reads.update(".".join(parts[: i + 1]) for i in range(len(parts)))
    return reads


class StaticInputsRule(Rule):
    id = "GL002"
    name = "static-inputs"
    version = "1"
    doc = (
        "after a CUDA-graph capture (capture_step(fn), a `with "
        "torch.cuda.graph(...)` body), the capturing function must not "
        "rebind (`x = ...`) a name the captured code reads — every replay "
        "goes on reading the buffer that was captured; write in place "
        "(`x.copy_(...)`, `x += ...`)"
    )

    def check_module(self, mod: ModuleInfo, project: Project):
        defs = _function_defs(mod.tree)
        for node in ast.walk(mod.tree):
            ctx = _graph_context(node) if isinstance(node, ast.With) else None
            if ctx is not None:
                reads = _free_reads(node.body, set())
                label = f"`{ctx}(...)` body"
                end = node.end_lineno or node.lineno
            elif isinstance(node, ast.Call) and _captured_target(node) is not None:
                fns = _resolve(_captured_target(node), defs)
                if not fns:
                    continue
                reads = set()
                for fn in fns:
                    body = fn.body if isinstance(fn.body, list) else [fn.body]
                    reads |= _free_reads(body, _param_names(fn))
                label = f"`{getattr(fns[0], 'name', '<lambda>')}`"
                stmt = node
                while not isinstance(stmt, ast.stmt):
                    stmt = stmt.parent
                end = getattr(stmt, "end_lineno", None) or node.lineno
            else:
                continue
            site = _enclosing_function(node)
            for other in ast.walk(site if site is not None else mod.tree):
                if not isinstance(other, (ast.Assign, ast.AnnAssign)) or other.value is None:
                    continue
                if other.lineno <= end or _enclosing_function(other) is not site:
                    continue
                targets = other.targets if isinstance(other, ast.Assign) else [other.target]
                rebound = sorted({t for tgt in targets for t in _target_exprs(tgt)} & reads)
                if rebound:
                    names = ", ".join(f"`{n}`" for n in rebound)
                    yield self.finding(
                        mod,
                        other,
                        f"{names} rebound after the CUDA-graph capture at "
                        f"line {node.lineno}, whose {label} reads it — every "
                        "replay still reads the captured buffer; write in "
                        f"place (`{rebound[0]}.copy_(...)`)",
                    )


# ---------------------------------------------------------------------------
# GL003 — registry lock discipline
# ---------------------------------------------------------------------------

_WRITE_SQL = ("INSERT", "UPDATE", "DELETE", "REPLACE")


def _first_sql_fragment(node: ast.Call) -> Optional[str]:
    if not node.args:
        return None
    arg = node.args[0]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    if isinstance(arg, ast.JoinedStr) and arg.values:
        first = arg.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first.value
    return None


def _inside_lock_with(node: ast.AST) -> bool:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, ast.With):
            for item in cur.items:
                if dotted_name(item.context_expr).endswith("._lock"):
                    return True
        cur = getattr(cur, "parent", None)
    return False


class LockDisciplineRule(Rule):
    id = "GL003"
    name = "lock-discipline"
    version = "1"
    doc = (
        "in classes that own a `self._lock`, every INSERT/UPDATE/DELETE "
        "execute() must be lexically inside `with self._lock` — a write "
        "outside the lock races concurrent writers (the archival-walk "
        "bug class); helpers called with the lock already held use the "
        "`*_locked` naming convention"
    )

    def check_module(self, mod: ModuleInfo, project: Project):
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            if not self._owns_lock(cls):
                continue
            for node in ast.walk(cls):
                if not isinstance(node, ast.Call):
                    continue
                if not isinstance(node.func, ast.Attribute):
                    continue
                if node.func.attr not in ("execute", "executemany"):
                    continue
                sql = _first_sql_fragment(node)
                if sql is None:
                    continue
                head = sql.lstrip().upper()
                if not head.startswith(_WRITE_SQL):
                    continue
                if _inside_lock_with(node):
                    continue
                fn = _enclosing_function(node)
                fn_name = getattr(fn, "name", "<module>")
                # Convention: *_locked helpers run with the lock held by
                # the caller — the name is the contract.
                if fn_name.endswith("_locked"):
                    continue
                verb = head.split(None, 1)[0]
                yield self.finding(
                    mod,
                    node,
                    f"{verb} executed in `{cls.name}.{fn_name}` outside a "
                    "`with self._lock` block — registry writes must hold "
                    "the write lock (rename to *_locked if the caller "
                    "holds it)",
                )

    def _owns_lock(self, cls: ast.ClassDef) -> bool:
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if dotted_name(t) == "self._lock":
                        return True
        return False


# ---------------------------------------------------------------------------
# GL004 — tick-path blocking
# ---------------------------------------------------------------------------

_REGISTRARS = {"add_beat_hook": 0, "register_handler": 1}
_TASK_DECORATORS = ("bus.register",)


def _blocking_calls(fn: ast.AST) -> Iterable[Tuple[ast.Call, str]]:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        kws = call_keywords(node)
        if name == "time.sleep":
            yield node, "time.sleep() blocks the tick thread"
        elif name.endswith("urlopen") and "timeout" not in kws:
            yield node, "urlopen() without an explicit timeout"
        elif (
            name in ("smtplib.SMTP", "smtplib.SMTP_SSL")
            and "timeout" not in kws
        ):
            yield node, f"{name}() without an explicit timeout"
        elif (
            name.startswith("subprocess.")
            and name.split(".")[-1]
            in ("run", "call", "check_call", "check_output")
            and "timeout" not in kws
        ):
            yield node, f"{name}() without an explicit timeout"
        elif name.endswith("create_connection") and "timeout" not in kws:
            yield node, f"{name}() without an explicit timeout"
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in ("wait", "join")
            and not node.args
            and "timeout" not in kws
            and dotted_name(node.func).startswith("self._thread")
        ):
            yield node, "unbounded thread wait"


class TickPathRule(Rule):
    id = "GL004"
    name = "tick-path"
    version = "1"
    doc = (
        "functions registered as reporter beat hooks, command-bus "
        "handlers (register_handler), or scheduler bus tasks ride the "
        "heartbeat/monitor tick — they must not sleep, do network I/O "
        "without a timeout, or run un-timeboxed subprocesses"
    )

    def prepare(self, project: Project) -> None:
        # Project-wide class index: `x = ClassName(...)` registrations
        # resolve methods across modules (worker.py registers
        # capture_agent.poll; CaptureAgent lives in tracking/).
        self._classes: Dict[str, Tuple[ModuleInfo, ast.ClassDef]] = {}
        for mod in project.modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    self._classes.setdefault(node.name, (mod, node))
        #: (module rel, function node) resolved tick-path callables
        self._targets: List[Tuple[ModuleInfo, ast.AST, str]] = []
        for mod in project.modules:
            self._collect_targets(mod)

    def _collect_targets(self, mod: ModuleInfo) -> None:
        # Local constructor assignments: name -> class name.
        ctor_types: Dict[str, str] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tname = dotted_name(node.targets[0])
                if (
                    tname
                    and isinstance(node.value, ast.Call)
                    and dotted_name(node.value.func) in self._classes
                ):
                    ctor_types[tname] = dotted_name(node.value.func)
                elif (
                    tname
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "configure"
                ):
                    # tracking.capture.configure(...) returns the agent.
                    ctor_types.setdefault(tname, "CaptureAgent")
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                fname = dotted_name(node.func).rsplit(".", 1)[-1]
                if fname in _REGISTRARS:
                    pos = _REGISTRARS[fname]
                    if len(node.args) > pos:
                        self._resolve_target(
                            mod, node.args[pos], ctor_types, fname
                        )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    dec_call = dec.func if isinstance(dec, ast.Call) else dec
                    if dotted_name(dec_call) in _TASK_DECORATORS:
                        self._targets.append((mod, node, "bus task"))

    def _resolve_target(
        self,
        mod: ModuleInfo,
        arg: ast.AST,
        ctor_types: Dict[str, str],
        registrar: str,
    ) -> None:
        how = f"registered via {registrar}"
        if isinstance(arg, ast.Lambda):
            self._targets.append((mod, arg, how))
            return
        if isinstance(arg, ast.Name):
            for fn in _function_defs(mod.tree).get(arg.id, ()):
                self._targets.append((mod, fn, how))
            return
        if not isinstance(arg, ast.Attribute):
            return
        method = arg.attr
        base = dotted_name(arg.value)
        cls_name: Optional[str] = None
        if base == "self":
            cur = getattr(arg, "parent", None)
            while cur is not None and not isinstance(cur, ast.ClassDef):
                cur = getattr(cur, "parent", None)
            if cur is not None:
                cls_name = cur.name
        else:
            cls_name = ctor_types.get(base)
        if cls_name is None or cls_name not in self._classes:
            return
        cls_mod, cls_node = self._classes[cls_name]
        for node in cls_node.body:
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == method
            ):
                self._targets.append(
                    (cls_mod, node, f"{how} ({cls_name}.{method})")
                )

    def check_module(self, mod: ModuleInfo, project: Project):
        for target_mod, fn, how in self._targets:
            if target_mod is not mod:
                continue
            label = getattr(fn, "name", "<lambda>")
            for call, why in _blocking_calls(fn):
                yield self.finding(
                    mod,
                    call,
                    f"blocking call in tick-path function `{label}` "
                    f"({how}): {why}",
                )


# ---------------------------------------------------------------------------
# GL005 — knob registry
# ---------------------------------------------------------------------------

_KNOB_TOKEN = _re.compile(r"POLYAXON_TPU_[A-Z0-9_]*")
_CATALOG_REL = "conf/knobs.py"


class KnobRegistryRule(Rule):
    id = "GL005"
    name = "knob-registry"
    version = "1"
    doc = (
        "every POLYAXON_TPU_* string literal must resolve to an entry in "
        "the conf/knobs.py catalog (exact name, declared family prefix, "
        "or family member), and every catalog entry must be referenced "
        "somewhere — a typo'd knob silently no-ops, a dead entry "
        "documents a knob that does nothing"
    )

    def prepare(self, project: Project) -> None:
        self._used: Set[str] = set()
        self._family_used: Set[str] = set()
        for mod in project.modules:
            if mod.rel.endswith(_CATALOG_REL):
                continue
            for token, _ in self._tokens(mod):
                if token in KNOBS:
                    self._used.add(token)
                for fam in FAMILIES:
                    if token.startswith(fam):
                        self._family_used.add(fam)

    def _tokens(self, mod: ModuleInfo):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                for token in _KNOB_TOKEN.findall(node.value):
                    yield token, node

    def check_module(self, mod: ModuleInfo, project: Project):
        if mod.rel.endswith(_CATALOG_REL):
            return
        for token, node in self._tokens(mod):
            if self._known(token):
                continue
            yield self.finding(
                mod,
                node,
                f"`{token}` is not in the conf/knobs.py catalog — a "
                "typo'd knob silently no-ops; declare it (or fix the "
                "name)",
            )

    def _known(self, token: str) -> bool:
        if token in KNOBS:
            return True
        if token.endswith("_"):
            # A prefix mention (docstrings: POLYAXON_TPU_WATCHDOG_*).
            return any(
                name.startswith(token) for name in (*KNOBS, *FAMILIES)
            )
        # Dynamic family member (POLYAXON_TPU_ALERT_MFU_LOW_FLOOR).
        return any(token.startswith(fam) for fam in FAMILIES)

    def finalize(self, project: Project):
        catalog_mod = next(
            (m for m in project.modules if m.rel.endswith(_CATALOG_REL)), None
        )
        if catalog_mod is None:
            return
        entries = [(name, name in self._used) for name in KNOBS]
        entries += [(fam, fam in self._family_used) for fam in FAMILIES]
        for name, used in entries:
            if used:
                continue
            line = 1
            for i, text in enumerate(catalog_mod.source.splitlines(), 1):
                if f'"{name}"' in text:
                    line = i
                    break
            yield Finding(
                rule=self.id,
                path=catalog_mod.rel,
                line=line,
                col=0,
                message=(
                    f"dead catalog entry `{name}` — no module references "
                    "it; delete it or wire the call site through a knob "
                    "accessor"
                ),
            )


# ---------------------------------------------------------------------------
# GL006 — network timeouts, package-wide
# ---------------------------------------------------------------------------

class NetTimeoutRule(Rule):
    id = "GL006"
    name = "net-timeout"
    version = "1"
    doc = (
        "network I/O (urlopen, smtplib.SMTP, socket.create_connection, "
        "requests.*) must pass an explicit timeout everywhere — a hung "
        "endpoint must never hang the caller (CLI included: the control "
        "plane being down should error, not freeze the terminal)"
    )

    _REQUESTS = {
        "requests.get", "requests.post", "requests.put",
        "requests.delete", "requests.head", "requests.request",
    }

    def check_module(self, mod: ModuleInfo, project: Project):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            kws = call_keywords(node)
            if "timeout" in kws:
                continue
            if name.endswith("urlopen"):
                yield self.finding(
                    mod, node,
                    "urlopen() without an explicit timeout — a silent "
                    "endpoint hangs the caller forever",
                )
            elif name in ("smtplib.SMTP", "smtplib.SMTP_SSL"):
                yield self.finding(
                    mod, node,
                    f"{name}() without an explicit timeout",
                )
            elif name.endswith("socket.create_connection") or name == (
                "create_connection"
            ):
                yield self.finding(
                    mod, node,
                    "socket.create_connection() without an explicit "
                    "timeout",
                )
            elif name in self._REQUESTS:
                yield self.finding(
                    mod, node,
                    f"{name}() without an explicit timeout",
                )


# ---------------------------------------------------------------------------
# GL007 — metric label hygiene
# ---------------------------------------------------------------------------

#: The mechanism module — ``labeled_key`` itself and ``fold_labeled_key``
#: (which legitimately re-emits arbitrary label-key sets via ``**``).
_METRICS_MECHANISM_REL = "stats/metrics.py"

#: The closed label-key vocabulary.  A new label key is a schema decision
#: — every dashboard/alert joins on it — so adding one here should be a
#: deliberate, reviewed act, with a bounded value vocabulary to match.
_ALLOWED_LABEL_KEYS = {
    # control-plane self-telemetry (registry ops, tick phases, API)
    "op", "phase", "route", "method", "code",
    # alert lifecycle
    "rule", "run", "severity",
    # remediation / notifier / autoscaler
    "action", "outcome", "direction",
    # serving fleet
    "replica", "fleet",
    # metric history / burn-rate SLOs (slo_burn_* / slo_budget_remaining
    # gauges — value bounded by the per-run declared SLO names)
    "slo",
    # renderer-owned exposition labels
    "le", "component", "process", "version", "kind",
}


def _is_stringy(node: ast.AST) -> bool:
    return isinstance(node, ast.JoinedStr) or (
        isinstance(node, ast.Constant) and isinstance(node.value, str)
    )


def _interpolation_kind(value: ast.AST) -> Optional[str]:
    """How a label-value expression interpolates, or None if it doesn't.

    Lexical: flags the construction *shapes* (f-string, ``.format``,
    %-format, string concatenation) that splice an identifier into the
    value at the call site.  A plain variable passes — the cardinality
    cap is the runtime backstop for those.
    """
    if isinstance(value, ast.JoinedStr):
        return "an f-string"
    if (
        isinstance(value, ast.Call)
        and isinstance(value.func, ast.Attribute)
        and value.func.attr == "format"
    ):
        return "a .format() call"
    if isinstance(value, ast.BinOp):
        if isinstance(value.op, ast.Mod) and _is_stringy(value.left):
            return "%-formatting"
        if isinstance(value.op, ast.Add) and (
            _is_stringy(value.left) or _is_stringy(value.right)
        ):
            return "string concatenation"
    return None


class MetricLabelRule(Rule):
    id = "GL007"
    name = "metric-labels"
    version = "1"
    doc = (
        "labeled_key() label keys must come from the allowed-label "
        "catalog, and label values must not be built by interpolation "
        "(f-string/.format/%-format/concatenation) — a spliced unbounded "
        "identifier mints one series per value, growing /metrics and "
        "every snapshot without limit"
    )

    def check_module(self, mod: ModuleInfo, project: Project):
        if mod.rel.endswith(_METRICS_MECHANISM_REL):
            return
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name != "labeled_key" and not name.endswith(".labeled_key"):
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    yield self.finding(
                        mod,
                        node,
                        "labeled_key() called with a **kwargs label set — "
                        "the label keys can't be reviewed against the "
                        "allowed catalog; pass explicit keywords",
                    )
                    continue
                if kw.arg not in _ALLOWED_LABEL_KEYS:
                    yield self.finding(
                        mod,
                        kw.value,
                        f"label key `{kw.arg}` is not in the allowed "
                        "label-key catalog (analysis/rules.py:"
                        "_ALLOWED_LABEL_KEYS) — new label keys are a "
                        "metrics-schema decision; add it deliberately "
                        "with a bounded value vocabulary",
                    )
                kind = _interpolation_kind(kw.value)
                if kind is not None:
                    yield self.finding(
                        mod,
                        kw.value,
                        f"label value for `{kw.arg}` built via {kind} — "
                        "interpolating an identifier mints one series per "
                        "value; map it through a closed vocabulary first",
                    )


# ---------------------------------------------------------------------------
# GL008 — span-name hygiene
# ---------------------------------------------------------------------------

#: The tracing mechanism module — ``Tracer.record_span`` legitimately
#: re-emits whatever name a ``_Span`` carried.
_TRACE_MECHANISM_REL = "tracking/trace.py"

#: Forwarding wrappers: the ``name`` parameter flows through verbatim,
#: so the literal check applies at THEIR call sites, not inside them.
_SPAN_FORWARDERS = {"_trace_span", "_trace_hot"}

#: The closed span-name catalog.  A span name is a Perfetto track and a
#: cross-process join key — interpolating per-request/per-task values
#: into it mints one track per value; new names are a schema decision,
#: added here deliberately (the GL007 label-key pattern, applied to
#: trace spans).
_SPAN_NAMES = {
    # worker lifecycle
    "worker.cmd", "worker.distributed_init", "worker.entrypoint",
    # control plane
    "gang.spawn", "task.execute", "watcher.observe",
    # training + input pipeline
    "train.aot_compile", "train.loop", "train.step",
    "pipeline.drain", "pipeline.gather",
    # serving engine lifecycle + request phases
    "engine.compile", "serving.warmup", "serving.step", "serving.prefill",
    "serving.request", "serving.generate", "serving.admit",
    "serving.queue_wait", "serving.prefill.chunk", "serving.first_token",
    "serving.prefix_cache.hit", "serving.decode.step",
    "serving.spec.draft", "serving.spec.verify",
    "serving.park", "serving.spill", "serving.restore", "serving.finish",
    # fleet router
    "router.request", "router.attempt",
}

#: Literal shape: lowercase dot-delimited segments, at least two deep —
#: the convention every catalogued name follows.
_SPAN_NAME_SHAPE = _re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")


class SpanNameRule(Rule):
    id = "GL008"
    name = "span-names"
    version = "1"
    doc = (
        "Tracer.span()/record_span() names must be literal dot-delimited "
        "strings from the span-name catalog (analysis/rules.py:"
        "_SPAN_NAMES) — an interpolated name mints one Perfetto track "
        "per value and breaks cross-process trace merging; variable "
        "parts belong in span attributes"
    )

    def check_module(self, mod: ModuleInfo, project: Project):
        if mod.rel.endswith(_TRACE_MECHANISM_REL):
            return
        # Map every Call to its enclosing function, so the forwarding
        # wrappers' own pass-through emission is exempt.
        enclosing: Dict[ast.AST, str] = {}
        for fn in ast.walk(mod.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Call):
                        enclosing[sub] = fn.name
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = dotted_name(node.func).rsplit(".", 1)[-1]
            if tail in ("span", "record_span"):
                arg_idx = 0
            elif tail in _SPAN_FORWARDERS:
                arg_idx = 1  # (req, name, ...)
            else:
                continue
            if len(node.args) <= arg_idx:
                continue  # keyword-form or unrelated zero-arg .span()
            arg = node.args[arg_idx]
            if isinstance(arg, ast.Constant) and not isinstance(
                arg.value, str
            ):
                continue  # e.g. re.Match.span(group)
            if not (
                isinstance(arg, ast.Constant) and isinstance(arg.value, str)
            ):
                if enclosing.get(node) in _SPAN_FORWARDERS:
                    continue  # the wrapper forwarding its name param
                yield self.finding(
                    mod,
                    arg,
                    f"span name passed to {tail}() is not a string "
                    "literal — interpolated names mint one Perfetto "
                    "track per value; put the variable part in a span "
                    "attribute",
                )
                continue
            value = arg.value
            if not _SPAN_NAME_SHAPE.match(value):
                yield self.finding(
                    mod,
                    arg,
                    f"span name {value!r} is not dot-delimited "
                    "(`component.phase`) — names are cross-process "
                    "join keys and follow one convention",
                )
            elif value not in _SPAN_NAMES:
                yield self.finding(
                    mod,
                    arg,
                    f"span name {value!r} is not in the span-name "
                    "catalog (analysis/rules.py:_SPAN_NAMES) — new "
                    "span names are a tracing-schema decision; add it "
                    "deliberately",
                )


# ---------------------------------------------------------------------------

ALL_RULES = [
    CapturePurityRule,
    StaticInputsRule,
    LockDisciplineRule,
    TickPathRule,
    KnobRegistryRule,
    NetTimeoutRule,
    MetricLabelRule,
    SpanNameRule,
]


def default_rules() -> List[Rule]:
    return [cls() for cls in ALL_RULES]


def rule_by_id(rule_id: str) -> Optional[type]:
    for cls in ALL_RULES:
        if cls.id == rule_id:
            return cls
    return None
