"""CLI: ``python -m polyaxon_tpu_torch.analysis [paths] [--rules GL001,GL003]
[--format json] [--show-suppressed] [--list-rules] [--no-state]``.

Exit status 1 when any unsuppressed finding remains (CI keys off this).
A successful CLI run also records a state file that the
``check_static_analysis`` /status probe reports from; pass ``--no-state``
to skip that.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List

from polyaxon_tpu_torch.analysis import default_rules, package_root, rule_by_id
from polyaxon_tpu_torch.analysis.core import load_project, run_rules
from polyaxon_tpu_torch.analysis.reporter import (
    render_json,
    render_text,
    write_state,
)


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m polyaxon_tpu_torch.analysis",
        description="graft-lint: the platform's static-analysis pass",
    )
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files/dirs to lint (default: the polyaxon_tpu_torch package)",
    )
    parser.add_argument(
        "--rules", default="",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
    )
    parser.add_argument(
        "--show-suppressed", action="store_true",
        help="include suppressed findings in the report",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    parser.add_argument(
        "--no-state", action="store_true",
        help="don't record this run in the health-probe state file",
    )
    args = parser.parse_args(argv)

    rules = default_rules()
    if args.list_rules:
        for rule in rules:
            print(f"{rule.id} {rule.name} (v{rule.version})")
            print(f"    {rule.doc}")
        return 0

    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - {r.id for r in rules}
        if unknown:
            parser.error(f"unknown rule id(s): {', '.join(sorted(unknown))}")
        rules = [r for r in rules if r.id in wanted]

    paths = args.paths or [package_root()]
    project = load_project(paths)
    findings = run_rules(project, rules)

    if args.format == "json":
        print(render_json(findings, rules, args.show_suppressed))
    else:
        print(render_text(findings, rules, args.show_suppressed))

    if not args.no_state:
        try:
            write_state(findings, rules)
        except OSError:
            pass

    return 1 if any(not f.suppressed for f in findings) else 0


if __name__ == "__main__":
    sys.exit(main())
