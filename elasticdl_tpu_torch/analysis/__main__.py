"""CLI: ``python -m elasticdl_tpu_torch.analysis [paths...] [--rule NAME]``.

The port's copy of ``python -m elasticdl_tpu.analysis``: the same flags,
the same ``--format json`` fields and the same ``--baseline`` semantics.
Exit status: 0 when every invariant holds, 1 when violations were found,
2 on usage errors (including a scan that matched zero files, and an
unreadable --baseline).  With no paths, scans the installed
``elasticdl_tpu_torch`` package (tests are exercised separately by the
fixtures of tests/test_torch_analysis.py).

``--format json`` emits stable machine-readable findings::

    {"findings": [{"rule", "path", "line", "col", "message"}, ...],
     "suppressed": N, "suppressed_by_rule": {...},
     "files_scanned": N, "rules": [...],
     "timing": {"program-index": s, "<rule>": s, ...},
     "graph": {"modules": N, "edges": N, "fixpoint_iterations": N}}

``timing`` is per-rule wall seconds (plus the whole-program index
build); ``graph`` sizes the cross-module call graph the protocol rules
reasoned over — both rendered by ``python -m
elasticdl_tpu_torch.analysis.report``.

``--baseline FILE`` reads a JSON allowlist (the same shape as the
``--format json`` output, or a bare list of findings) and drops any
finding matching a baseline entry by (rule, path[, message]) — so a new
rule can gate incrementally: snapshot today's findings, burn the
baseline down over time.  Baselined findings count as suppressed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from elasticdl_tpu_torch.analysis.core import (
    discover_files,
    format_violations,
    scan,
)
from elasticdl_tpu_torch.analysis.rules import ALL_RULES, RULE_NAMES


def default_paths():
    """The port's package (its model zoo lives inside it, ``zoo/``)."""
    return [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]


def _load_baseline(path: str):
    """Baseline entries as a list of dicts with rule/path[/message]."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("findings", [])
    if not isinstance(data, list):
        raise ValueError("baseline must be a JSON list or {'findings': [...]}")
    entries = []
    for item in data:
        if not isinstance(item, dict) or "rule" not in item or "path" not in item:
            raise ValueError(
                "each baseline entry needs at least 'rule' and 'path'"
            )
        entries.append(item)
    return entries


def _normalize(path: str) -> str:
    return os.path.normpath(path).replace("\\", "/")


def _baselined(violation, entries) -> bool:
    v_path = _normalize(violation.path)
    for entry in entries:
        if entry["rule"] != violation.rule:
            continue
        e_path = _normalize(str(entry["path"]))
        # Exact match, or a suffix match across an absolute/relative
        # spelling difference — but only when the shorter path still
        # carries a directory component: a bare basename entry
        # ('trainer.py') must NOT allowlist every trainer.py in the tree.
        if v_path != e_path:
            if "/" in e_path and v_path.endswith("/" + e_path):
                pass
            elif "/" in v_path and "/" in e_path and e_path.endswith(
                "/" + v_path
            ):
                pass
            else:
                continue
        if "message" in entry and entry["message"] != violation.message:
            continue
        return True
    return False


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m elasticdl_tpu_torch.analysis",
        description="Invariant analyzer for the port's elastic control "
        "plane and its device step (control-plane, protocol and hot-path "
        "rules).",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files or directories to scan (default: the "
        "elasticdl_tpu_torch package)",
    )
    parser.add_argument(
        "--rule",
        action="append",
        choices=RULE_NAMES,
        help="run only this rule (repeatable; default: all rules)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format (json: stable machine-readable findings)",
    )
    parser.add_argument(
        "--baseline",
        metavar="FILE",
        help="JSON allowlist of known findings to ignore (same shape as "
        "--format json output); lets a new rule gate incrementally",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="list rules and exit"
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        for name in RULE_NAMES:
            doc = (ALL_RULES[name].__doc__ or "").strip().splitlines()
            print(f"{name}: {doc[0] if doc else ''}")
        return 0

    baseline = []
    if args.baseline:
        try:
            baseline = _load_baseline(args.baseline)
        except (OSError, ValueError, json.JSONDecodeError) as exc:
            print(f"error: unreadable --baseline {args.baseline}: {exc}",
                  file=sys.stderr)
            return 2

    rules = [ALL_RULES[name] for name in (args.rule or RULE_NAMES)]
    paths = args.paths or default_paths()
    for path in paths:
        if not os.path.exists(path):
            print(f"error: no such path: {path}", file=sys.stderr)
            return 2

    if not discover_files(paths):
        # An OK verdict over zero files is a false green gate (typoed
        # directory, non-.py argument) — refuse instead.
        print(f"error: no .py files found under: {' '.join(paths)}",
              file=sys.stderr)
        return 2

    report = scan(paths, rules)
    violations = report.violations
    suppressed = list(report.suppressed)
    if baseline:
        surviving = []
        for violation in violations:
            if _baselined(violation, baseline):
                suppressed.append(violation)
            else:
                surviving.append(violation)
        violations = surviving

    if args.format == "json":
        by_rule = {}
        for violation in suppressed:
            by_rule[violation.rule] = by_rule.get(violation.rule, 0) + 1
        print(json.dumps(
            {
                "findings": [
                    {
                        "rule": v.rule,
                        "path": v.path,
                        "line": v.line,
                        "col": v.col,
                        "message": v.message,
                    }
                    for v in violations
                ],
                "suppressed": len(suppressed),
                "suppressed_by_rule": by_rule,
                "files_scanned": len(report.files),
                "rules": list(args.rule or RULE_NAMES),
                "timing": {
                    name: round(seconds, 4)
                    for name, seconds in report.timings.items()
                },
                "graph": report.graph,
            },
            indent=2,
        ))
        return 1 if violations else 0

    if violations:
        print(format_violations(violations))
        print(
            f"\n{len(violations)} invariant violation(s). "
            "Suppress a deliberate exception with "
            "'# noqa-invariant: <rule> (<reason>)'.",
            file=sys.stderr,
        )
        return 1
    print(f"check-invariants: OK ({', '.join(r for r in (args.rule or RULE_NAMES))})")
    if report.graph:
        print(
            "program graph: {modules} modules, {edges} edges, "
            "{fixpoint_iterations} fixpoint iteration(s)".format(
                **report.graph
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
