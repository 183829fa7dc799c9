"""Per-rule summary table for the port analyzer's JSON output.

The port's copy of the JAX package's ``scripts/invariant_report.py``::

    python -m elasticdl_tpu_torch.analysis elasticdl_tpu_torch \
        --format json > findings.json
    python -m elasticdl_tpu_torch.analysis.report findings.json

Reads the analyzer's ``--format json`` document (from a file argument,
``-``, or stdin) and prints one row per rule: surviving findings and
suppressed (noqa'd / baselined) findings.  Exit status is always 0 —
the analyzer's own exit code is the gate; this is the human-readable
chaser.  Stdlib-only, like the analyzer.
"""

from __future__ import annotations

import json
import sys


def render(data: dict) -> str:
    findings = data.get("findings", [])
    suppressed_by_rule = data.get("suppressed_by_rule", {})
    rules = data.get("rules", [])
    counts: dict = {}
    for finding in findings:
        rule = finding.get("rule", "?")
        counts[rule] = counts.get(rule, 0) + 1
    names = list(rules)
    for name in sorted(set(counts) | set(suppressed_by_rule)):
        if name not in names:
            names.append(name)
    width = max([len(name) for name in names] + [len("rule")]) + 2
    lines = [f"{'rule'.ljust(width)}{'findings':>9}{'suppressed':>12}"]
    for name in names:
        lines.append(
            f"{name.ljust(width)}{counts.get(name, 0):>9}"
            f"{suppressed_by_rule.get(name, 0):>12}"
        )
    lines.append(
        f"{'total'.ljust(width)}{len(findings):>9}"
        f"{data.get('suppressed', 0):>12}"
        f"   ({data.get('files_scanned', 0)} files scanned)"
    )
    # Cost visibility: where the analyzer's wall time goes,
    # rule family by rule family, plus the size of the cross-module
    # graph the whole-program rules reasoned over.
    timing = data.get("timing", {})
    if timing:
        total_s = sum(timing.values())
        slowest = sorted(timing.items(), key=lambda kv: -kv[1])
        lines.append(
            "timing: "
            + ", ".join(f"{name} {seconds:.2f}s" for name, seconds in slowest)
            + f"   (total {total_s:.2f}s)"
        )
    graph = data.get("graph", {})
    if graph:
        lines.append(
            "program graph: {modules} modules, {edges} edges, "
            "{fixpoint_iterations} fixpoint iteration(s)".format(**graph)
        )
    # The counts alone don't locate anything: repeat each finding in the
    # analyzer's text format so the table stays actionable.
    if findings:
        lines.append("")
        for finding in findings:
            lines.append(
                f"{finding.get('path', '?')}:{finding.get('line', 0)}:"
                f"{finding.get('col', 0)}: [{finding.get('rule', '?')}] "
                f"{finding.get('message', '')}"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        if argv and argv[0] not in ("-",):
            with open(argv[0], "r", encoding="utf-8") as f:
                data = json.load(f)
        else:
            data = json.load(sys.stdin)
    except (OSError, ValueError) as exc:
        # An empty/missing findings file means the analyzer itself
        # failed before producing JSON (usage error, bad path); its
        # stderr already explains why — don't bury it under a traceback.
        print(f"analysis.report: no findings JSON ({exc}); "
              "see the analyzer's own error above")
        return 0
    print(render(data))
    return 0


if __name__ == "__main__":
    sys.exit(main())
