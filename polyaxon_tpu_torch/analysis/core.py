"""graft-lint core, the port's copy of ``polyaxon_tpu/analysis/core.py``:
module loading, suppression parsing, rule driving.

The port's invariants — nothing a captured CUDA graph runs reads or waits
for the host, a captured step's inputs keep their buffers, registry writes
inside the write lock, non-blocking tick paths, the central knob catalog,
timeouts on every network call, bounded metric labels and span names —
hold at runtime only where a phase of ``chip_smoke.py`` or a budget happens
to look.  This package enforces them *statically*, at review time: an AST
pass over ``polyaxon_tpu_torch/`` with one rule per bug class (see
``rules.py`` for the catalog).  This module is the reference's, line for
line but for this docstring.

Suppression syntax (every suppression should carry a justification —
the self-clean test asserts it)::

    do_thing()  # graft-lint: disable=GL004 -- bounded by the 5s deadline

    # graft-lint: disable=GL003 -- caller holds _lock (see _delete_tree)
    conn.execute("DELETE ...")

    # graft-lint: disable-file=GL005 -- generated knob fixtures

A standalone suppression comment applies to the next line; a trailing
one to its own line; ``disable-file`` to the whole file.  ``disable=all``
suppresses every rule.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "ModuleInfo",
    "Project",
    "Rule",
    "load_module",
    "load_project",
    "run_rules",
]

_SUPPRESS_RE = re.compile(
    r"#\s*graft-lint:\s*(disable|disable-file)=([A-Za-z0-9_,\s]+?)"
    r"(?:\s*--\s*(.*))?$"
)


@dataclass
class Finding:
    """One rule violation at one location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def as_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "suppressed": self.suppressed,
            "suppress_reason": self.suppress_reason,
        }


@dataclass
class Suppression:
    rules: Set[str]  # rule ids, or {"all"}
    reason: str


@dataclass
class ModuleInfo:
    """One parsed source file plus its suppression map."""

    path: Path
    rel: str
    source: str
    tree: ast.Module
    #: line -> suppression active on that line
    line_suppressions: Dict[int, Suppression] = field(default_factory=dict)
    #: file-wide suppressions
    file_suppressions: Dict[str, Suppression] = field(default_factory=dict)

    def suppression_for(self, rule_id: str, line: int) -> Optional[Suppression]:
        sup = self.file_suppressions.get(rule_id) or self.file_suppressions.get(
            "all"
        )
        if sup is not None:
            return sup
        sup = self.line_suppressions.get(line)
        if sup is not None and (rule_id in sup.rules or "all" in sup.rules):
            return sup
        return None


@dataclass
class Project:
    """Every module under analysis (rules needing global state — the
    knob catalog cross-check, callback registration resolution — read
    from here)."""

    modules: List[ModuleInfo]
    root: Path

    def by_rel(self, rel: str) -> Optional[ModuleInfo]:
        for mod in self.modules:
            if mod.rel == rel or mod.rel.endswith(rel):
                return mod
        return None


class Rule:
    """One checker.  Subclasses set the class attributes and implement
    :meth:`check_module` (per-file findings) and optionally
    :meth:`prepare` / :meth:`finalize` (project-wide passes)."""

    id: str = "GL000"
    name: str = "base"
    version: str = "1"
    doc: str = ""

    def prepare(self, project: Project) -> None:  # pragma: no cover - hook
        pass

    def check_module(
        self, mod: ModuleInfo, project: Project
    ) -> Iterable[Finding]:  # pragma: no cover - hook
        return ()

    def finalize(self, project: Project) -> Iterable[Finding]:
        return ()

    def finding(
        self, mod: ModuleInfo, node: ast.AST, message: str
    ) -> Finding:
        return Finding(
            rule=self.id,
            path=mod.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


# -- parsing -----------------------------------------------------------------

def _parse_suppressions(
    source: str,
) -> Tuple[Dict[int, Suppression], Dict[str, Suppression]]:
    line_sup: Dict[int, Suppression] = {}
    file_sup: Dict[str, Suppression] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        kind, raw_rules, reason = m.group(1), m.group(2), m.group(3) or ""
        rules = {r.strip() for r in raw_rules.split(",") if r.strip()}
        sup = Suppression(rules=rules, reason=reason.strip())
        if kind == "disable-file":
            for rule in rules:
                file_sup[rule] = sup
            continue
        line_sup[i] = sup
        # A standalone comment line suppresses the next line too.
        if text.lstrip().startswith("#"):
            line_sup[i + 1] = sup
    return line_sup, file_sup


def attach_parents(tree: ast.AST) -> None:
    """Give every node a ``.parent`` pointer (rules walk ancestry for
    lexical checks like with-block membership)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def load_module(path: Path, root: Path) -> Optional[ModuleInfo]:
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError, ValueError):
        return None
    attach_parents(tree)
    try:
        rel = str(path.relative_to(root))
    except ValueError:
        rel = str(path)
    line_sup, file_sup = _parse_suppressions(source)
    return ModuleInfo(
        path=path,
        rel=rel,
        source=source,
        tree=tree,
        line_suppressions=line_sup,
        file_suppressions=file_sup,
    )


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(
                f
                for f in sorted(p.rglob("*.py"))
                if "__pycache__" not in f.parts
            )
        elif p.suffix == ".py":
            out.append(p)
    return out


def load_project(paths: Sequence[Path], root: Optional[Path] = None) -> Project:
    paths = [Path(p) for p in paths]
    if root is None:
        root = paths[0] if paths[0].is_dir() else paths[0].parent
    modules = [
        m for f in iter_py_files(paths) if (m := load_module(f, root))
    ]
    return Project(modules=modules, root=root)


# -- driving -----------------------------------------------------------------

def run_rules(project: Project, rules: Sequence[Rule]) -> List[Finding]:
    """Run every rule over every module; returns findings (suppressed
    ones included, marked) sorted by location."""
    findings: List[Finding] = []
    for rule in rules:
        rule.prepare(project)
    for rule in rules:
        for mod in project.modules:
            for f in rule.check_module(mod, project):
                _apply_suppression(mod, f)
                findings.append(f)
        for f in rule.finalize(project):
            mod = next((m for m in project.modules if m.rel == f.path), None)
            if mod is not None:
                _apply_suppression(mod, f)
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def _apply_suppression(mod: ModuleInfo, f: Finding) -> None:
    sup = mod.suppression_for(f.rule, f.line)
    if sup is not None:
        f.suppressed = True
        f.suppress_reason = sup.reason


# -- shared AST helpers ------------------------------------------------------

def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains ('' for anything else)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        # e.g. ``socket.socket().connect`` — keep the attribute tail.
        parts.append("()")
    else:
        return ""
    return ".".join(reversed(parts))


def call_keywords(node: ast.Call) -> Set[str]:
    return {kw.arg for kw in node.keywords if kw.arg is not None}


def string_constants(tree: ast.AST) -> Iterable[Tuple[str, ast.AST]]:
    """Every string constant in the tree, f-string fragments included."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value, node
