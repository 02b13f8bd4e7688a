"""graft-lint output, the port's copy of ``polyaxon_tpu/analysis/reporter.py``:
text/JSON renderers + the state file the ``check_static_analysis`` /status
probe (``checks/health.py``) reads."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from polyaxon_tpu_torch.analysis.core import Finding, Rule
from polyaxon_tpu_torch.conf.knobs import knob_str

__all__ = [
    "render_text",
    "render_json",
    "summarize",
    "state_file_path",
    "write_state",
    "read_state",
]


def summarize(findings: Sequence[Finding], rules: Sequence[Rule]) -> Dict:
    unsuppressed = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    by_rule: Dict[str, int] = {}
    for f in unsuppressed:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "unsuppressed": len(unsuppressed),
        "suppressed": len(suppressed),
        "by_rule": by_rule,
        "rules": {r.id: {"name": r.name, "version": r.version} for r in rules},
    }


def render_text(
    findings: Sequence[Finding],
    rules: Sequence[Rule],
    show_suppressed: bool = False,
) -> str:
    lines: List[str] = []
    for f in findings:
        if f.suppressed and not show_suppressed:
            continue
        tag = " (suppressed)" if f.suppressed else ""
        lines.append(f"{f.location()}: {f.rule}{tag}: {f.message}")
    summary = summarize(findings, rules)
    lines.append(
        f"graft-lint: {summary['unsuppressed']} finding(s), "
        f"{summary['suppressed']} suppressed, "
        f"{len(rules)} rule(s)"
    )
    return "\n".join(lines)


def render_json(
    findings: Sequence[Finding],
    rules: Sequence[Rule],
    show_suppressed: bool = False,
) -> str:
    payload = {
        "findings": [
            f.as_dict()
            for f in findings
            if show_suppressed or not f.suppressed
        ],
        "summary": summarize(findings, rules),
    }
    return json.dumps(payload, indent=2, sort_keys=True)


# -- state file (read by checks/health.py:check_static_analysis) -------------

def state_file_path() -> Path:
    """Resolved lazily so tests can monkeypatch the env."""
    override = knob_str("POLYAXON_TPU_LINT_STATE")
    if override:
        return Path(override).expanduser()
    home = knob_str("POLYAXON_TPU_HOME")
    return Path(home).expanduser() / "analysis" / "last_run.json"


def write_state(
    findings: Sequence[Finding],
    rules: Sequence[Rule],
    path: Optional[Path] = None,
) -> Path:
    path = path or state_file_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = dict(summarize(findings, rules), ts=time.time())
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(payload, sort_keys=True), encoding="utf-8")
    tmp.replace(path)
    return path


def read_state(path: Optional[Path] = None) -> Optional[Dict]:
    path = path or state_file_path()
    try:
        return json.loads(path.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
