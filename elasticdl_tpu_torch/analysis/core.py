"""Analyzer framework: file model, suppression, discovery, runner.

The port's copy of ``elasticdl_tpu/analysis/core.py``.  A *rule* is a
callable ``rule(source: SourceFile) -> List[Violation]`` registered in
`elasticdl_tpu_torch.analysis.rules`.  This module owns everything
rule-agnostic:

- `SourceFile` parses a file once (AST + per-line comments) and is
  shared by every rule;
- inline suppression: a violation is dropped when its line (or the
  statement's first line) carries
  ``# noqa-invariant: <rule> (<reason>)`` — comma-separated rule names,
  or ``*`` for all rules.  The reason is required: a suppression without
  one does not suppress, and its finding survives with a note saying so;
- `run_checks` walks the requested paths and returns violations sorted
  by (path, line).

Only stdlib imports: the analyzer must run on boxes where torch is not
importable (pre-commit hooks, bare CI runners).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set

#: Inline suppression marker, e.g.
#: ``foo()  # noqa-invariant: rpc-deadline (the caller bounds it)``
_NOQA_RE = re.compile(r"#\s*noqa-invariant:\s*([\w*,\s-]+)")

#: The reason that must follow the rule names: ``(<non-empty text>)``.
_REASON_RE = re.compile(r"\s*\(\s*[^)\s][^)]*\)")

#: Appended to a finding whose suppression carries no reason.
NO_REASON_NOTE = (
    " [suppressed without a reason: write "
    "'# noqa-invariant: <rule> (<reason>)']"
)

#: Inline guarded-field annotation, e.g.
#: ``self._todo = deque()  # guarded-by: _lock`` — consumed by the
#: lock-discipline rule, parsed here so SourceFile owns all comment IR.
_GUARDED_INLINE_RE = re.compile(r"#\s*guarded-by:\s*(\w+)\s*$")

#: Standalone multi-field form (subclasses re-declaring inherited fields):
#: ``# guarded-by: _lock: _handles, _num_workers``
_GUARDED_BLOCK_RE = re.compile(r"#\s*guarded-by:\s*(\w+)\s*:\s*([\w,\s]+)$")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


@dataclass
class SourceFile:
    """One parsed source file, shared across rules."""

    path: str  # as given (normally repo-relative)
    text: str
    tree: ast.AST
    #: line number -> set of suppressed rule names ("*" = all)
    noqa: Dict[int, Set[str]] = field(default_factory=dict)
    #: lines whose ``noqa-invariant`` comment gives no ``(<reason>)``
    noqa_without_reason: Set[int] = field(default_factory=set)
    #: line number -> full comment text on that line (if any)
    comments: Dict[int, str] = field(default_factory=dict)
    #: decorator line -> line of the `def` it decorates: a suppression on
    #: the def line covers violations reported on its decorator lines.
    decorated_def_line: Dict[int, int] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, text: Optional[str] = None) -> "SourceFile":
        if text is None:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        tree = ast.parse(text, filename=path)
        source = cls(path=path, text=text, tree=tree)
        source._collect_comments()
        source._map_decorator_lines()
        return source

    def _map_decorator_lines(self):
        for node in ast.walk(self.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue
            if not node.decorator_list:
                continue
            first = node.decorator_list[0].lineno
            for line in range(first, node.lineno):
                self.decorated_def_line[line] = node.lineno

    def _collect_comments(self):
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                line = tok.start[0]
                self.comments[line] = tok.string
                match = _NOQA_RE.search(tok.string)
                if match:
                    names = {
                        name.strip()
                        for name in match.group(1).split(",")
                        if name.strip()
                    }
                    self.noqa.setdefault(line, set()).update(names)
                    if not _REASON_RE.match(tok.string, match.end()):
                        self.noqa_without_reason.add(line)
        except tokenize.TokenError:
            pass  # AST parsed fine; comment-level features degrade

    # -- comment-derived annotations ----------------------------------

    def guarded_inline(self, line: int) -> Optional[str]:
        """Lock name from an inline ``# guarded-by: <lock>`` on `line`."""
        comment = self.comments.get(line)
        if not comment:
            return None
        match = _GUARDED_INLINE_RE.search(comment)
        return match.group(1) if match else None

    def guarded_blocks(self, first_line: int, last_line: int) -> Dict[str, str]:
        """field -> lock from standalone ``# guarded-by: <lock>: f1, f2``
        comments between `first_line` and `last_line` (a class span)."""
        mapping: Dict[str, str] = {}
        for line in range(first_line, last_line + 1):
            comment = self.comments.get(line)
            if not comment:
                continue
            match = _GUARDED_BLOCK_RE.search(comment)
            if not match:
                continue
            lock = match.group(1)
            for name in match.group(2).split(","):
                name = name.strip()
                if name:
                    mapping[name] = lock
        return mapping

    def suppressing_line(self, rule: str, line: int) -> Optional[int]:
        """The line whose ``noqa-invariant`` names `rule` for a finding on
        `line` (its own, or the def line of the decorator it sits on)."""
        for candidate in (line, self.decorated_def_line.get(line)):
            if candidate is None:
                continue
            names = self.noqa.get(candidate)
            if names and (rule in names or "*" in names):
                return candidate
        return None

    def suppressed(self, rule: str, line: int) -> bool:
        """True when a ``noqa-invariant`` with a reason covers the finding."""
        candidate = self.suppressing_line(rule, line)
        return candidate is not None and candidate not in self.noqa_without_reason

    def unreasoned(self, violation: Violation) -> Violation:
        """`violation` with the note that its suppression lacks a reason."""
        return Violation(violation.rule, violation.path, violation.line,
                         violation.col, violation.message + NO_REASON_NOTE)


def discover_files(paths: Sequence[str]) -> List[str]:
    """Expand files/directories into a sorted .py file list."""
    found: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            for root, dirs, names in os.walk(path):
                dirs[:] = sorted(
                    d for d in dirs if d not in ("__pycache__", ".git")
                )
                for name in sorted(names):
                    if name.endswith(".py"):
                        found.append(os.path.join(root, name))
        elif path.endswith(".py"):
            found.append(path)
    return found


@dataclass
class ScanReport:
    """Full result of one analyzer pass: surviving violations, the
    noqa-suppressed ones (for reporting), the files scanned, per-rule
    wall time, and the cross-module graph stats of the program index."""

    violations: List[Violation]
    suppressed: List[Violation]
    files: List[str]
    timings: Dict[str, float] = field(default_factory=dict)
    graph: Dict[str, int] = field(default_factory=dict)


def scan(
    paths: Sequence[str],
    rules: Iterable[Callable[[SourceFile], List[Violation]]],
) -> ScanReport:
    """Run `rules` over every .py under `paths`, splitting findings into
    surviving vs inline-suppressed.

    All files parse FIRST, then one whole-program index is built over
    the full set (import resolution + cross-module call graph — see
    program.py) and attached to every SourceFile, so the protocol rules
    see across module boundaries.  Per-rule wall time and the graph
    stats ride the report for ``analysis/report.py``'s cost lines.
    """
    import time

    rules = list(rules)
    violations: List[Violation] = []
    suppressed: List[Violation] = []
    files = discover_files(paths)
    sources: List[SourceFile] = []
    for file_path in files:
        try:
            sources.append(SourceFile.parse(file_path))
        except SyntaxError as exc:
            violations.append(
                Violation(
                    rule="parse",
                    path=file_path,
                    line=exc.lineno or 0,
                    col=exc.offset or 0,
                    message=f"could not parse: {exc.msg}",
                )
            )
            continue
        except (OSError, UnicodeDecodeError, ValueError) as exc:
            # Unreadable / non-UTF-8 source must fail the gate as a
            # finding, not crash the whole pass with a traceback.
            violations.append(
                Violation(
                    rule="parse",
                    path=file_path,
                    line=0,
                    col=0,
                    message=f"could not read: {exc}",
                )
            )
            continue
    timings: Dict[str, float] = {}
    graph: Dict[str, int] = {}
    start = time.perf_counter()
    # No fallback to per-file analysis: a broken index would silently
    # drop every cross-module finding, so it raises instead.
    from elasticdl_tpu_torch.analysis.program import build_program_index

    program = build_program_index(sources)
    for source in sources:
        source._program_index = program
    graph = program.stats()
    timings["program-index"] = time.perf_counter() - start
    for rule in rules:
        name = getattr(rule, "_rule_name", getattr(rule, "__name__", "rule"))
        start = time.perf_counter()
        for source in sources:
            for violation in rule(source):
                line = source.suppressing_line(violation.rule, violation.line)
                if line is None:
                    violations.append(violation)
                elif line in source.noqa_without_reason:
                    violations.append(source.unreasoned(violation))
                else:
                    suppressed.append(violation)
        timings[name] = timings.get(name, 0.0) + (
            time.perf_counter() - start
        )
    key = lambda v: (v.path, v.line, v.col, v.rule)  # noqa: E731
    violations.sort(key=key)
    suppressed.sort(key=key)
    return ScanReport(violations=violations, suppressed=suppressed,
                      files=files, timings=timings, graph=graph)


def run_checks(
    paths: Sequence[str],
    rules: Iterable[Callable[[SourceFile], List[Violation]]],
) -> List[Violation]:
    """Run `rules` over every .py under `paths`; suppressions applied."""
    return scan(paths, rules).violations


def format_violations(violations: Sequence[Violation]) -> str:
    return "\n".join(v.format() for v in violations)
